"""The host side of ``scan``: set-up, the input pipeline, the loop and the
drain around the device step (``scanstep.scan_step``).

    run(args, timers)
      ScanPlan.from_args     what the call fixes: panels, pairs, options,
                             header and row layout
      open_source            the allele source: tile directories or the
                             extractor (opened once, under ``setup.open``)
      replay_journal         rows a ``--journal`` already holds
      InputPipeline          chunk k: extract on one worker, build on the
                             other, dealt whole to device k mod D
        extract_native / load_chunk    the chunk's windows from the source
        build_native / build_tiles     the wire batch, with PanelMasks and
                                       EhhFocus, then ``deal_wire``
      the step               ``scan_step`` queued on the batch's device
      Drain                  the rows back, the exact recompute, emit_batch

Each batch costs one host enqueue of the step however many devices there
are; no tensor moves between devices.  The spans and counters (names in
``runtime/profiling.py`` and README, "Operator's note") are recorded on
the main thread and on the pipeline's two workers (``extract``,
``build``).  ``scanstep.deal_wire``, ``scan_step``, ``rows_to_host`` and
``scan_step_fstg_exact`` are looked up on the module at each call, so a
caller may substitute them.
"""
from __future__ import annotations

import collections
import concurrent.futures as futures
import functools
import json
import sys
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np

from impop_tpu_torch import scanstep
from impop_tpu_torch.device import on_device
from impop_tpu_torch.hostio import (GenoSource, GfaDirSource, _capacity_for,
                                    _open_extractor, _out_stream,
                                    _panel_label, _print_counters,
                                    _resolve_fasta, _scan_buf_layout, _warn,
                                    _write_window_log, expand_population,
                                    pack_scan_batch, read_bed,
                                    read_panel_file, site_weights_from_keys,
                                    split_multiallelic)
from impop_tpu_torch.parallel import distributed
from impop_tpu_torch.runtime.journal import ResultJournal
from impop_tpu_torch.runtime.profiling import (StageTimers, count,
                                               device_trace, span)

__all__ = ["ScanPlan", "ScanSource", "PanelMasks", "EhhFocus", "ShapeFloors",
           "Prepared", "InputPipeline", "Drain", "open_source",
           "replay_journal", "extract_native", "load_chunk", "build_native",
           "build_tiles", "emit_batch", "run"]

Window = Tuple[object, str]         # (region, region string)


class ScanPlan(NamedTuple):
    """What a call fixes at set-up."""
    panel_names: List[str]
    panel_lists: List[list]
    p_count: int                    # max(1, panels)
    pair_list: List[Tuple[int, int]]
    pair_key: tuple                 # pair_list as the step's key
    threshold: float
    use_weights: bool
    want_ehh: bool
    want_afs: bool
    afs_bins: int
    afs_folded: bool
    batch_size: int
    header: List[str]
    lay: dict                       # ``scanstep.row_layout``
    pair_a: np.ndarray
    pair_b: np.ndarray

    @classmethod
    def from_args(cls, args) -> "ScanPlan":
        with span("setup.panels"):
            panel_files = sorted(args.panel or [])
            panel_names = [_panel_label(p) for p in panel_files]
            panel_lists = [read_panel_file(p) for p in panel_files]
        pairs = [(i, j) for i in range(len(panel_lists))
                 for j in range(i + 1, len(panel_lists))]
        header = ["REGION", "LENGTH", "SAMPLES", "SEGREGATING_SITES"]
        if panel_lists:
            for name in panel_names:
                header += [f"PI_{name}", f"TAJD_{name}"]
            for i, j in pairs:
                tag = f"{panel_names[i]}_{panel_names[j]}"
                header += [f"FST_{tag}", f"FSTG_{tag}", f"FST3_{tag}"]
        else:
            header += ["PI", "TAJIMAS_D"]
        if args.ehh:
            header += ["EHH_FOCAL", "EHH_AREA_REF", "EHH_CARR_REF",
                       "EHH_AREA_ALT", "EHH_CARR_ALT"]
        p_count = max(1, len(panel_lists))
        return cls(
            panel_names, panel_lists, p_count, pairs, tuple(pairs),
            float(args.threshold),
            args.identity_mode == "columns", bool(args.ehh), bool(args.afs),
            args.afs_bins, not args.afs_unfolded, args.batch, header,
            scanstep.row_layout(p_count, len(pairs), bool(args.ehh)),
            np.asarray([i for i, _ in pairs] or [0], np.int32),
            np.asarray([j for _, j in pairs] or [0], np.int32))

    def disjoint_of(self, panels: np.ndarray) -> bool:
        """No window of ``panels`` [W, P, N] has a row in both panels of a
        pair (the step's disjoint route)."""
        return bool(self.pair_list) and not bool(
            (panels[:, self.pair_a] & panels[:, self.pair_b]).any())


class PanelMasks:
    """The one owner of panel membership: a window's [P, n] bool masks,
    row i in panel p when the stem of row i's name (up to its first
    ``:``) matches panel p's list (``expand_population``: a prefix test
    on the stem).  Panel prefixes never reach into the ``:start-end``
    suffix of extracted names, so windows of one row set share an entry.

    Two tables of 64 entries, one a call: by the stems of a window's names
    (:meth:`for_names`, the tile path) and by row set (:meth:`for_row_set`,
    the native path, which only the build worker calls).  A row set's key
    (:meth:`row_set_key`) is the target and the window's name blob with its
    reference row, the whole line equal to its region string, blanked to a
    NUL line, which no name holds.  Two windows of one key hold the same
    names at the same sorted positions but that row, whose stem the target
    fixes, so their masks are equal.  :meth:`panels_native` groups a
    native batch's windows by that key in one call (``NativeBatch.
    row_sets``) and builds the key of each set's first window alone."""

    def __init__(self, panel_lists: Sequence[list]):
        self.panel_lists = list(panel_lists)
        self._by_stems = functools.lru_cache(maxsize=64)(self._resolve)
        self.for_row_set = functools.lru_cache(maxsize=64)(self._row_set)

    def _resolve(self, stems: tuple) -> np.ndarray:
        masks = np.zeros((max(1, len(self.panel_lists)), len(stems)), bool)
        for pi_idx, plist in enumerate(self.panel_lists):
            matched, _ = expand_population(plist, list(stems))
            for k, nm in enumerate(stems):
                if nm in matched:
                    masks[pi_idx, k] = True
        return masks

    def for_names(self, names: tuple) -> np.ndarray:
        return self._by_stems(tuple(n.split(":", 1)[0] for n in names))

    @staticmethod
    def row_set_key(target: str, blob: bytes,
                    region: str) -> Tuple[str, bytes]:
        ref = region.encode()
        at = (b"\n" + blob).find(b"\n" + ref + b"\n")
        if at >= 0:
            blob = blob[:at] + b"\0" + blob[at + len(ref):]
        return target, blob

    def _row_set(self, key: Tuple[str, bytes]) -> np.ndarray:
        target, blob = key
        names = blob.decode().splitlines()
        if "\0" in names:
            names[names.index("\0")] = target
        return self.for_names(tuple(names))

    def panels_native(self, groups, batches, out_rows: Sequence[np.ndarray],
                      w: int, cap_n: int) -> Tuple[np.ndarray, np.ndarray]:
        """The masks of open native batches' windows (``groups`` and
        ``out_rows`` as :func:`_kept_rows` gives them): ``(panels [w, P,
        cap_n], set_panels [S, P, cap_n])``, each buffer row the masks of
        its row set, the padding rows all-zero.  One ``NativeBatch.
        row_sets`` call a batch, one name blob, key and lookup a row set
        (the sets of one target in two batches share their key), one
        gather for the rows.  Counts ``build.row_sets`` (the S sets),
        ``masks.resolved_windows`` (sets not in the table) and
        ``masks.cached_windows`` (the other windows)."""
        set_ids: Dict[Tuple[str, bytes], int] = {}
        set_row = np.full(w, -1, np.int64)
        for (tgt, items), nb, rows in zip(groups, batches, out_rows):
            set_of, first = nb.row_sets([rs for _, rs in items])
            ids = np.array([set_ids.setdefault(
                self.row_set_key(tgt, nb.names_blob(f), items[f][1]),
                len(set_ids)) for f in first.tolist()], np.int64)
            ok = rows >= 0
            set_row[rows[ok]] = ids[set_of[ok]]
        misses = self.for_row_set.cache_info().misses
        # one all-zero set past the last, which the padding rows (-1) take
        set_panels = np.zeros((len(set_ids) + 1, len(self.panel_lists),
                               cap_n), bool)
        for key, k in set_ids.items():
            m = self.for_row_set(key)
            set_panels[k, :, :m.shape[1]] = m
        resolved = self.for_row_set.cache_info().misses - misses
        count("build.row_sets", len(set_ids))
        count("masks.resolved_windows", resolved)
        count("masks.cached_windows", int((set_row >= 0).sum()) - resolved)
        return set_panels[set_row], set_panels[:-1]


def _read_ehh_targets(path: Optional[str]) -> Dict[str, list]:
    """--ehh-focal: "chrom pos" lines (``#`` comments skipped)."""
    targets: Dict[str, list] = {}
    if path:
        with open(path) as fh:
            for ln in fh:
                parts = ln.split()
                if len(parts) >= 2 and not ln.startswith("#"):
                    targets.setdefault(parts[0], []).append(int(parts[1]))
    return targets


def _by_position(positions: list) -> Tuple[np.ndarray, np.ndarray,
                                            np.ndarray]:
    """``--ehh-focal`` positions of one chromosome: in file order, sorted,
    and the file index of each sorted one with a sentinel past the end."""
    pos = np.asarray(positions, np.int64)
    order = np.argsort(pos, kind="stable")
    return pos, pos[order], np.append(order, len(pos))


class EhhFocus:
    """The EHH focal of each window: the variant nearest the window's
    target, its first ``--ehh-focal`` position in file order, or its
    midpoint.  :meth:`index` (the tile path) and :meth:`focals_native`
    run on the build worker and record the chosen position in
    :attr:`position` (region string -> genomic position), which the drain
    reads on the main thread: a batch is built before its ``wait_input``
    returns, so its windows' entries are written before its emit reads
    them (later batches' entries may be added meanwhile: one dict item set
    or get is atomic under the interpreter lock)."""

    def __init__(self, targets_path: Optional[str]):
        self.targets = _read_ehh_targets(targets_path)
        self._sorted = {chrom: _by_position(pos)
                        for chrom, pos in self.targets.items()}
        self.position: Dict[str, int] = {}

    def targets_of(self, regs: Sequence) -> np.ndarray:
        """The windows' targets [W] (int64)."""
        starts = np.array([reg.start for reg in regs], np.int64)
        ends = np.array([reg.end for reg in regs], np.int64)
        target = (starts + ends) // 2
        chroms = np.array([reg.chrom for reg in regs], object)
        for chrom in self._sorted.keys() & set(chroms.tolist()):
            on = np.flatnonzero(chroms == chrom)
            pos, by_pos, order = self._sorted[chrom]
            lo = np.searchsorted(by_pos, starts[on], "left")
            hi = np.searchsorted(by_pos, ends[on], "left")
            # the least file index among the positions in [start, end)
            first = np.minimum.reduceat(order, np.stack([lo, hi], 1).ravel())
            inside = lo < hi
            target[on[inside]] = pos[first[::2][inside]]
        return target

    def focals_native(self, groups, batches, out_rows: Sequence[np.ndarray],
                      kept: Sequence[Window], w: int) -> np.ndarray:
        """The focal site index of each kept window [w] (uint32, 0 for a
        window without sites and for padding): one
        ``NativeBatch.nearest_sites`` call a batch."""
        target = self.targets_of([reg for reg, _ in kept])
        focals = np.zeros(w, np.uint32)
        for (_tgt, items), nb, rows in zip(groups, batches, out_rows):
            index, pos = nb.nearest_sites(np.where(rows >= 0, target[rows], 0))
            hit = np.flatnonzero(index >= 0)
            focals[rows[hit]] = index[hit]
            self.position.update(zip([items[k][1] for k in hit.tolist()],
                                     pos[hit].tolist()))
        return focals

    def index(self, reg, rs: str, pos_arr) -> int:
        """Window ``reg``'s focal index among its sites ``pos_arr`` (the
        tile path: the target by a loop, as :meth:`targets_of` finds it)."""
        if pos_arr is None or len(pos_arr) == 0:
            return 0
        target = (reg.start + reg.end) // 2
        for pos in self.targets.get(reg.chrom, ()):
            if reg.start <= pos < reg.end:
                target = pos
                break
        pos_arr = np.asarray(pos_arr)
        fi = int(np.argmin(np.abs(pos_arr - target)))
        self.position[rs] = int(pos_arr[fi])
        return fi


class ShapeFloors:
    """The native path's [n, s] shape floors: they only grow within a
    call, so later batches of a call keep its shapes."""

    def __init__(self):
        self.n, self.s = 64, 128

    def caps(self, n_max: int, s_max: int) -> Tuple[int, int]:
        cap_n = _capacity_for([max(self.n, n_max)])
        cap_s = ((max(self.s, s_max, 128) + 127) // 128) * 128
        self.n, self.s = max(self.n, cap_n), max(self.s, cap_s)
        return cap_n, cap_s


class Prepared(NamedTuple):
    """One built chunk: the wire batch on its device (None when no window
    of the chunk was kept), its kept windows, its failed ones
    ``(region string, error)``, whether its pairs are disjoint, and its
    caps (cap_n, cap_s)."""
    wire: object
    kept: List[Window]
    failures: List[Tuple[str, str]]
    disjoint: bool
    caps: Tuple[int, int]


class ScanSource(NamedTuple):
    """The call's allele source: a tile directory or an extractor."""
    geno: object
    extractor: object

    @property
    def native(self) -> bool:
        """Batches extracted and packed in native memory."""
        return (self.geno is None and self.extractor is not None
                and hasattr(self.extractor, "extract_batch_open"))


def _count_native(extractor, prefixes: Tuple[str, ...]) -> None:
    """The native extractor's clock and counts whose names start with one
    of ``prefixes``, as counters."""
    stats = getattr(extractor, "stats", None)
    if stats is not None:
        for key, v in stats().items():
            if key.startswith(prefixes):
                count(key, v)


def open_source(args) -> ScanSource:
    """The call's one open of its source; the native extractor's open
    clock and gauge are counted now, its extractions at the end of the
    call.  Nothing closes the extractor yet: its handles stay open to the
    end of the process."""
    geno = (GenoSource(args.geno_dir) if args.geno_dir
            else GfaDirSource(args.gfa_dir) if args.gfa_dir else None)
    with span("setup.open"):
        fasta_store = _resolve_fasta(args)
        extractor = (_open_extractor(args.paf, fasta_store)
                     if args.paf and fasta_store else None)
    _count_native(extractor, ("open.", "extractors.open"))
    if geno is None and extractor is None:
        raise SystemExit("error: provide --geno-dir, --gfa-dir, "
                         "--paf + --fasta, or --paf + --agc")
    return ScanSource(geno, extractor)


def replay_journal(regions, prefix: str, journal: ResultJournal, out,
                   afs_total: Optional[np.ndarray]) -> List[Window]:
    """Print the rows the journal holds (their spectra summed into
    ``afs_total``); returns the windows still to scan, in BED order."""
    pending: List[Window] = []
    for reg in regions:
        rs = reg.region_string(prefix)
        rec = journal.get(rs)
        if rec is None or "row" not in rec:
            pending.append((reg, rs))
            continue
        print(rec["row"], file=out)
        if afs_total is not None:
            sparse = rec.get("afs")
            if sparse is None:
                _warn(f"Warning: journal row for {rs} predates "
                      "--afs; spectrum will miss it")
            else:
                for pk, c in sparse.items():
                    pi_idx, k = map(int, pk.split(":"))
                    afs_total[pi_idx, k] += int(c)
    return pending


# ---------------------------------------------------------------- extract


def extract_native(extractor, chunk: Sequence[Window], batch: int):
    """One C++ call per target-contiguous window group: (groups, open
    native batches), which :func:`build_native` packs from and closes."""
    with span("extract", batch=batch):
        groups: List[Tuple[str, list]] = []
        for reg, rs in chunk:
            tgt = rs.rsplit(":", 1)[0]
            if groups and groups[-1][0] == tgt:
                groups[-1][1].append((reg, rs))
            else:
                groups.append((tgt, [(reg, rs)]))
        batches = [
            extractor.extract_batch_open(
                tgt, [(reg.start, reg.end) for reg, _ in items])
            for tgt, items in groups
        ]
    return groups, batches


def load_chunk(source: ScanSource, chunk: Sequence[Window], batch: int):
    """Tiles from ``--geno-dir`` / ``--gfa-dir`` or the per-window
    extractor, rows sorted by name: (tiles, kept, failures)."""
    with span("extract", batch=batch):
        tiles, kept, failures = [], [], []
        for reg, rs in chunk:
            try:
                if source.geno is not None:
                    g, names, keys = source.geno.load(rs)
                    g, keys = split_multiallelic(np.asarray(g, np.int8),
                                                 keys)
                else:
                    wm = source.extractor.extract(rs.rsplit(":", 1)[0],
                                                  reg.start, reg.end)
                    g, names, keys = wm.geno, wm.names, wm.site_keys
            except Exception as e:  # per-window skip-and-record
                failures.append((rs, str(e)))
                continue
            order = np.argsort(names)
            tiles.append((np.asarray(g, np.int8)[order],
                          [names[i] for i in order], keys))
            kept.append((reg, rs))
    return tiles, kept, failures


# ------------------------------------------------------------------ build


def _kept_rows(groups, batches):
    """The windows the native batches extracted: (failures, kept,
    out_rows), ``out_rows[g][k]`` the buffer row of window k of batch g,
    in kept's order, -1 for a failed window."""
    failures, kept, out_rows = [], [], []
    for (_tgt, items), nb in zip(groups, batches):
        ok = np.array([not err for err in nb.errors], bool)
        rows = np.full(nb.count, -1, np.int64)
        rows[ok] = np.arange(len(kept), len(kept) + int(ok.sum()))
        kept += [items[k] for k in np.flatnonzero(ok).tolist()]
        failures += [(items[k][1], nb.errors[k])
                     for k in np.flatnonzero(~ok).tolist()]
        out_rows.append(rows)
    return failures, kept, out_rows


def build_native(plan: ScanPlan, masks: PanelMasks, focus: EhhFocus,
                 floors: ShapeFloors, extracted, pad_to: Optional[int],
                 dev, batch: int) -> Prepared:
    """Wire-pack straight from the native batches' memory, then deal the
    batch to ``dev``; ``pad_to`` windows (else the kept ones), the
    padding all-zero rows (no members, length 0: inert).  The metadata
    comes a batch at a time: the row sets' masks (:meth:`PanelMasks.
    panels_native`) and the EHH focals (:meth:`EhhFocus.focals_native`);
    the pairs are disjoint when every row set's masks are."""
    groups, batches = extracted
    with span("build", batch=batch, cpu=True):
        failures, kept, out_rows = _kept_rows(groups, batches)
        if not kept:
            for nb in batches:
                nb.close()
            return Prepared(None, kept, failures, False, (0, 0))
        cap_n, cap_s = floors.caps(
            max(max((n for n, _ in nb.dims), default=1) for nb in batches),
            max(max((s for _, s in nb.dims), default=1) for nb in batches))
        w = pad_to or len(kept)
        blay = _scan_buf_layout(cap_n, cap_s, plan.p_count, plan.use_weights,
                                plan.want_ehh)
        flat = np.zeros((w, blay["total"]), np.uint8)
        with span("build.pack"):
            for nb, rows in zip(batches, out_rows):
                nb.pack_into(flat, rows.tolist(), cap_n, cap_s, blay["m"],
                             blay["sm"],
                             blay["w"] if plan.use_weights else -1)
        if plan.panel_lists:
            panels, set_panels = masks.panels_native(
                groups, batches, out_rows, w, cap_n)
        else:
            n_rows = np.zeros(w, np.int64)
            for nb, rows in zip(batches, out_rows):
                ok = rows >= 0
                n_rows[rows[ok]] = np.asarray(nb.dims, np.int64)[ok, 0]
            panels = (np.arange(cap_n) < n_rows[:, None])[:, None]
            set_panels = panels
        lengths = np.zeros(w, np.uint32)
        lengths[:len(kept)] = [reg.length for reg, _ in kept]
        if plan.want_ehh:
            focals = focus.focals_native(groups, batches, out_rows, kept, w)
        for nb in batches:
            nb.close()
        flat[:, blay["p"]:blay["l"]] = np.packbits(
            panels, axis=-1, bitorder="little").reshape(w, -1)
        flat[:, blay["l"]:blay["l"] + 4] = (
            lengths.astype("<u4").view(np.uint8).reshape(w, 4))
        if plan.want_ehh:
            flat[:, blay["f"]:blay["f"] + 4] = (
                focals.astype("<u4").view(np.uint8).reshape(w, 4))
        disjoint = plan.disjoint_of(set_panels)
    with span("h2d", batch=batch):
        wire = scanstep.deal_wire(flat, dev)
    return Prepared(wire, kept, failures, disjoint, (cap_n, cap_s))


def build_tiles(plan: ScanPlan, masks: PanelMasks, focus: EhhFocus,
                extracted, pad_to: Optional[int], dev,
                batch: int) -> Prepared:
    """Pad + fused pack (``pack_scan_batch``), then deal the batch to
    ``dev``; ``pad_to`` as in :func:`build_native`."""
    tiles, kept, failures = extracted
    if not tiles:
        return Prepared(None, kept, failures, False, (0, 0))
    with span("build", batch=batch, cpu=True):
        cap_n = _capacity_for([t0.shape[0] for t0, *_ in tiles])
        cap_s = max(128, max(t0.shape[1] for t0, *_ in tiles))
        cap_s = ((cap_s + 127) // 128) * 128
        w = pad_to or len(tiles)
        geno = np.full((w, cap_n, cap_s), -1, dtype=np.int8)
        member = np.zeros((w, cap_n), bool)
        smask = np.zeros((w, cap_s), bool)
        panels = np.zeros((w, plan.p_count, cap_n), bool)
        lengths = np.zeros(w, np.float32)
        wts = np.ones((w, cap_s), np.float32)
        focals = np.zeros(w, np.uint32) if plan.want_ehh else None
        for wi, ((g, names, keys), (reg, rs)) in enumerate(zip(tiles, kept)):
            n, s = g.shape
            geno[wi, :n, :s] = g
            member[wi, :n] = True
            smask[wi, :s] = True
            lengths[wi] = reg.length
            if plan.use_weights and keys is not None:
                wts[wi, :s] = site_weights_from_keys(keys)
            if plan.want_ehh:
                pos = ([int(k.split(":", 1)[0]) for k in keys]
                       if keys is not None else None)
                focals[wi] = focus.index(reg, rs, pos)
            if plan.panel_lists:
                panels[wi, :, :n] = masks.for_names(tuple(names))
            else:
                panels[wi, 0, :n] = True
        disjoint = plan.disjoint_of(panels)
        flat = pack_scan_batch(geno, member, smask, panels, lengths, wts,
                               plan.use_weights, focals)
    with span("h2d", batch=batch):
        wire = scanstep.deal_wire(flat, dev)
    return Prepared(wire, kept, failures, disjoint, (cap_n, cap_s))


# --------------------------------------------------------------- pipeline


class InputPipeline:
    """The two-stage host pipeline: chunk k+1 extracts on one worker while
    chunk k builds on the other and the devices compute the chunks before
    it; at least two built chunks, and one per device, are in flight.
    Chunk k, whole, goes to device k mod D: the deal depends on the
    chunk's index alone, not on thread timing.

    ``extract(chunk, k)`` runs on the ``extract`` worker, ``build(extracted,
    pad_to, device, k)`` on the ``build`` worker (each binds ``timers`` to
    its thread); iterating yields ``(k, build's result)`` in chunk order,
    each wait under ``wait_input``.  Use it as a context: leaving it shuts
    both workers down, pending chunks cancelled."""

    def __init__(self, chunks: Sequence[Sequence[Window]], devs: Sequence,
                 pad_to: int, extract: Callable, build: Callable,
                 timers: StageTimers):
        self.chunks, self.devs = list(chunks), list(devs)
        # one chunk pads to the kept windows, several to the batch size
        self.pad_to = pad_to if len(self.chunks) > 1 else None
        self.depth = max(2, len(self.devs))
        self.inflight: collections.deque = collections.deque()  # (k, fut)
        self._extract, self._build = extract, build
        self._next = 0
        self._pool_x = futures.ThreadPoolExecutor(
            max_workers=1, initializer=timers.bind, initargs=("extract",))
        self._pool_b = futures.ThreadPoolExecutor(
            max_workers=1, initializer=timers.bind, initargs=("build",))

    def __enter__(self) -> "InputPipeline":
        return self

    def __exit__(self, *exc) -> None:
        self._pool_x.shutdown(wait=True, cancel_futures=True)
        self._pool_b.shutdown(wait=True, cancel_futures=True)

    def _prepare(self, fx: futures.Future, k: int):
        return self._build(fx.result(), self.pad_to,
                           self.devs[k % len(self.devs)], k)

    def _top_up(self) -> None:
        while (self._next < len(self.chunks)
               and len(self.inflight) < self.depth):
            k = self._next
            fx = self._pool_x.submit(self._extract, self.chunks[k], k)
            self.inflight.append(
                (k, self._pool_b.submit(self._prepare, fx, k)))
            self._next += 1

    def __iter__(self):
        self._top_up()
        while self.inflight:
            k, built = self.inflight.popleft()
            with span("wait_input", batch=k):
                prepared = built.result()
            self._top_up()
            yield k, prepared


# ------------------------------------------------------------------ drain


def _write_afs(path: str, afs_total: np.ndarray, panel_names: List[str]
               ) -> None:
    """The genome-wide spectrum file of the JAX scan: one row per allele
    count k >= 1 that any panel has, one column per panel."""
    with open(path, "w") as fh:
        fh.write("ALLELE_COUNT\t" + "\t".join(
            f"SITES_{n}" for n in (panel_names or ["ALL"])) + "\n")
        for k in range(1, afs_total.shape[1]):
            if afs_total[:, k].any():
                fh.write(f"{k}\t" + "\t".join(
                    str(int(v)) for v in afs_total[:, k]) + "\n")


@functools.lru_cache(maxsize=8)
def _afs_keys(p_count: int, bins: int) -> np.ndarray:
    """The journal's spectrum keys ``"<panel>:<allele count>"`` for the
    counts 1..``bins`` of every panel, panel-major, as one object array."""
    return np.array([f"{p}:{k}" for p in range(p_count)
                     for k in range(1, bins + 1)], dtype=object)


def _cols(rows: np.ndarray, lay: dict, name: str, k: int) -> list:
    """Column group ``name`` (``k`` wide) of the rows, as float lists."""
    return rows[:, lay[name]:lay[name] + k].astype(np.float64).tolist()


def _emit_afs(afs_rows: np.ndarray, p_count: int, afs_total: np.ndarray,
              records: Optional[List[dict]]) -> None:
    """The batch's spectra ([W, P·(bins + 1)] of the rows) summed into
    ``afs_total``; with journal ``records``, each window's spectrum,
    sparse in its record so that a resumed scan still merges it (allele
    count 0 is never meaningful)."""
    w = afs_rows.shape[0]
    # the counts are exact integers in float32: [W, P, bins]
    hist = afs_rows.reshape(w, p_count, -1)[:, :, 1:]
    hist = hist.astype(np.int64).reshape(w, -1)
    afs_total[:, 1:] += hist.sum(axis=0).reshape(p_count, -1)
    if records is None:
        count("afs.bins_emitted", np.count_nonzero(hist))
        return
    # window-major, then panel, then count: each window's run of nonzero
    # bins in the journal's order
    at = np.flatnonzero(hist)
    count("afs.bins_emitted", at.size)
    per_w = hist.shape[1]
    keys = _afs_keys(p_count, per_w // p_count)[at % per_w].tolist()
    vals = hist.ravel()[at].tolist()
    ends = np.searchsorted(at, per_w * np.arange(1, w + 1))
    lo = 0
    for rec, hi in zip(records, ends.tolist()):
        rec["afs"] = dict(zip(keys[lo:hi], vals[lo:hi]))
        lo = hi


def emit_batch(packed: np.ndarray, kept: Sequence[Tuple[object, str]],
               lay: dict, panel_names: Sequence[str],
               pair_list: Sequence[Tuple[int, int]], out,
               journal: ResultJournal,
               ehh_focal_pos: Optional[Dict[str, int]] = None,
               afs_total: Optional[np.ndarray] = None,
               log_dir: Optional[str] = None,
               threshold: Optional[float] = None) -> None:
    """Emit one batch of ``scan`` rows: the table's lines in one write,
    with ``afs_total`` the spectra summed in, with a journal file one
    append of the batch's records, with ``log_dir`` a log a window.

    ``packed`` is the step's [W, row width] rows (``scanstep.row_layout``
    gives ``lay``); the first ``len(kept)`` are the windows ``kept``
    lists, ``(region, region string)``, and rows past them (a short last
    chunk's padding) are never read.  ``ehh_focal_pos`` (region string ->
    focal position) is given with ``--ehh``, ``afs_total`` ([P, bins + 1]
    int64) with ``--afs``.  Each column group is read once for the batch;
    the cells are the per-window formulas' text, byte for byte."""
    w = len(kept)
    rows = packed[:w]
    p_count = max(1, len(panel_names))
    n_v = rows[:, lay["n"]].astype(np.int64).tolist()
    s_v = rows[:, lay["s"]].astype(np.int64).tolist()
    pi_v, d_v = (_cols(rows, lay, name, p_count) for name in ("pi", "d"))
    q = len(pair_list)
    fst_v, fstg_v, f3_v = (_cols(rows, lay, name, q)
                           for name in ("fst", "fstg", "f3"))
    if ehh_focal_pos is not None:
        # [area_ref, area_alt, carriers_ref, carriers_alt]
        area_v = _cols(rows, lay, "ehh", 2)
        carr_v = rows[:, lay["ehh"] + 2:lay["ehh"] + 4].astype(
            np.int64).tolist()
    lines = []
    for wi, (reg, rs) in enumerate(kept):
        length = reg.length
        cells = [rs, str(length), str(n_v[wi]), str(s_v[wi])]
        for pv, dv in zip(pi_v[wi], d_v[wi]):
            cells += (f"{pv / length:.8f}", "NA" if dv != dv else f"{dv:.6f}")
        for fv, gv, tv in zip(fst_v[wi], fstg_v[wi], f3_v[wi]):
            cells += (f"{fv:.8f}", f"{gv:.8f}",
                      "NA" if tv != tv else f"{tv:.8f}")
        if ehh_focal_pos is not None:
            fp = ehh_focal_pos.get(rs)
            (a_ref, a_alt), (c_ref, c_alt) = area_v[wi], carr_v[wi]
            cells += ("NA" if fp is None else str(fp), f"{a_ref:.6f}",
                      str(c_ref), f"{a_alt:.6f}", str(c_alt))
        lines.append("\t".join(cells))
        if log_dir:
            payload = {"region": rs, "length": length,
                       "threshold": threshold, "n": n_v[wi],
                       "segregating_sites": s_v[wi]}
            for pname, pv, dv in zip(panel_names or ["ALL"], pi_v[wi],
                                     d_v[wi]):
                payload[f"pi_{pname}"] = pv / length
                payload[f"tajd_{pname}"] = "NA" if dv != dv else dv
            for (i, j), fv, gv, tv in zip(pair_list, fst_v[wi], fstg_v[wi],
                                          f3_v[wi]):
                tag = f"{panel_names[i]}_{panel_names[j]}"
                payload[f"fst_{tag}"] = fv
                payload[f"fstg_{tag}"] = gv
                payload[f"fst3_{tag}"] = "NA" if tv != tv else tv
            _write_window_log(log_dir, rs, "Fused Scan Window", payload)
    records = [{"row": ln} for ln in lines] if journal.path else None
    if afs_total is not None:
        with span("emit.afs"):
            _emit_afs(rows[:, lay["afs"]:], p_count, afs_total, records)
    if records is not None:
        journal.record_many(zip((rs for _, rs in kept), records))
        count("journal.writes")
    out.write("".join(ln + "\n" for ln in lines))


class Drain:
    """Each stepped batch's rows are copied to the host from its own
    device as soon as its step is queued; every ``group_size`` batches
    the host waits for and emits the group before, so the devices compute
    while it drains.  A batch's drain: ``fetch`` (the wait for its rows),
    the exact recompute (``device.exact``) and ``emit``, in chunk order."""

    def __init__(self, plan: ScanPlan, out, journal: ResultJournal,
                 focus: EhhFocus, afs_total: Optional[np.ndarray],
                 log_dir: Optional[str], group_size: int,
                 timers: StageTimers):
        self.plan, self.out, self.journal = plan, out, journal
        self.focal_pos = focus.position if plan.want_ehh else None
        self.afs_total, self.log_dir = afs_total, log_dir
        self.group_size, self.timers = group_size, timers
        self.group: list = []     # [(k, (host, done), kept, wire, caps)]
        self.behind: Optional[list] = None    # the group before
        self.n_done = 0

    def add(self, k: int, fetched, prepared: Prepared) -> None:
        self.group.append((k, fetched, prepared.kept, prepared.wire,
                           prepared.caps))
        if len(self.group) >= self.group_size:
            self._flush()

    def finish(self) -> None:
        self._flush()
        if self.behind is not None:
            self._drain(self.behind)
            self.behind = None

    def _flush(self) -> None:
        if not self.group:
            return
        if self.behind is not None:
            self._drain(self.behind)
        self.behind, self.group = self.group, []

    def _drain(self, metas: list) -> None:
        """Rows past a batch's kept windows (the padding of a short last
        chunk) are never read."""
        plan = self.plan
        for k, (host, done), kept, wire, caps in metas:
            with span("fetch", batch=k):
                if done is not None:
                    done.synchronize()        # the barrier
                packed = host.numpy()
            packed = self._exact_fstg(packed, kept, wire, caps, k)
            with span("emit", batch=k):
                self.timers.add_windows(len(kept))
                emit_batch(packed, kept, plan.lay, plan.panel_names,
                           plan.pair_list, self.out, self.journal,
                           self.focal_pos, self.afs_total, self.log_dir,
                           plan.threshold)
            self.n_done += len(kept)

    def _exact_fstg(self, packed, kept, wire, caps, k: int) -> np.ndarray:
        """Windows flagged seed_risk re-run their grouped Fst through the
        exact first-found-pair program, on their batch's device; only
        their FSTG changes."""
        plan, lay = self.plan, self.plan.lay
        if not plan.pair_list:
            return packed
        risk = np.nonzero(packed[:len(kept), lay["risk"]] > 0)[0]
        if risk.size == 0:
            return packed
        with span("device.exact", batch=k), on_device(wire.device):
            exact = scanstep.scan_step_fstg_exact(
                wire, caps[0], caps[1], plan.p_count, plan.pair_key,
                plan.threshold, rows=[int(r) for r in risk],
                use_weights=plan.use_weights,
                use_ehh=plan.want_ehh).cpu().numpy()
        packed = packed.copy()
        packed[risk, lay["fstg"]:lay["f3"]] = exact
        return packed


# -------------------------------------------------------------------- run


def _regions(args, rank: int, world: int):
    """The BED's windows, this rank's contiguous share of them with
    ``--distributed`` (its outputs renamed ``<file>.partK``)."""
    with span("setup.bed"):
        regions = read_bed(args.bed)
    if world > 1:
        lo, hi = distributed.host_window_range(len(regions), rank, world)
        regions = regions[lo:hi]
        for attr in ("output", "journal", "afs", "timing_json"):
            if getattr(args, attr, None):
                setattr(args, attr, f"{getattr(args, attr)}.part{rank}")
    return regions


def _stages(source: ScanSource, plan: ScanPlan, masks: PanelMasks,
            focus: EhhFocus):
    """The pipeline's extract and build for the call's source."""
    if source.native:
        return (functools.partial(extract_native, source.extractor),
                functools.partial(build_native, plan, masks, focus,
                                  ShapeFloors()))
    return (functools.partial(load_chunk, source),
            functools.partial(build_tiles, plan, masks, focus))


def _scan_loop(plan: ScanPlan, pipe: InputPipeline, drain: Drain,
               journal: ResultJournal) -> int:
    """Step every built chunk on its device and hand its rows to the
    drain; returns the count of failed windows."""
    n_failed = 0
    for k, prep in pipe:
        for rs, err in prep.failures:
            _warn(f"Warning: {rs}: {err}; recording NA")
            journal.record_failure(rs, err)
            n_failed += 1
        if prep.wire is None:
            continue
        with span("device", batch=k, cpu=True), on_device(prep.wire.device):
            out_dev = scanstep.scan_step(
                prep.wire, prep.caps[0], prep.caps[1], plan.p_count,
                plan.pair_key, plan.threshold, prep.disjoint,
                plan.use_weights, plan.want_ehh, plan.want_afs,
                plan.afs_bins, plan.afs_folded)
            fetched = scanstep.rows_to_host(out_dev)
        drain.add(k, fetched, prep)
    drain.finish()
    return n_failed


def _close_call(args, timers: StageTimers, plan: ScanPlan,
                afs_total: Optional[np.ndarray]) -> None:
    if plan.want_afs:
        _write_afs(args.afs, afs_total, plan.panel_names)
        _warn(f"wrote genome-wide spectrum -> {args.afs}")
    if args.verbose_timing:
        _warn(timers.report())
    if args.timing_json:
        with open(args.timing_json, "w") as fh:
            json.dump(timers.to_json(), fh)
    if args.distributed:
        distributed.finalize()


def run(args, timers: StageTimers) -> int:
    """``scan`` with ``args`` (the ``scan`` parser's), recording into
    ``timers`` (bound to the calling thread as ``main``)."""
    rank, world = distributed.maybe_initialize(args.distributed)
    with span("setup"):
        devs = distributed.process_devices(args.device)
        if devs[0].type == "cuda":
            from impop_tpu_torch.ops._build import load_library

            with span("setup.build"):
                load_library()
        regions = _regions(args, rank, world)
        source = open_source(args)
        plan = ScanPlan.from_args(args)
        with span("setup.journal"):
            journal = ResultJournal(args.journal)
        afs_total = (np.zeros((plan.p_count, plan.afs_bins + 1), np.int64)
                     if plan.want_afs else None)
        focus = EhhFocus(args.ehh_focal if plan.want_ehh else None)
        masks = PanelMasks(plan.panel_lists)

    out = _out_stream(args.output)
    try:
        print("\t".join(plan.header), file=out)
        pending = replay_journal(regions, args.prefix, journal, out,
                                 afs_total)
        chunks = [pending[lo:lo + plan.batch_size]
                  for lo in range(0, len(pending), plan.batch_size)]
        drain = Drain(plan, out, journal, focus, afs_total, args.log_dir,
                      max(1, int(args.drain_group or 4)), timers)
        with device_trace(args.profile_dir, timers), InputPipeline(
                chunks, devs, plan.batch_size,
                *_stages(source, plan, masks, focus), timers) as pipe:
            n_failed = _scan_loop(plan, pipe, drain, journal)
        _count_native(source.extractor, ("extract.",))
        _print_counters(drain.n_done, n_failed)
    finally:
        if out is not sys.stdout:
            out.close()
    _close_call(args, timers, plan, afs_total)
    return 0
