"""Command-line entry point of the port.

    python -m impop_tpu_torch.cli scan -b windows.bed --paf aln.paf \\
        --fasta haps.fa --panel agc.AFR --panel agc.EUR ... --device cuda
    python -m impop_tpu_torch.cli tajd -b windows.bed --geno-dir tiles/ \\
        [-s samples.txt] [-l LEN] --device cuda
    python -m impop_tpu_torch.cli pi -b windows.bed --sim-dir sims/ \\
        [-u agc.EUR] [-r 5] --device cuda

Every subcommand takes the flags of the same subcommand of
``python -m impop_tpu.cli``, plus ``--device {cuda,cpu}``, and writes the
same table, window logs and counters.

``scan``: per batch of windows the host extracts allele tiles, packs them
into the shared 2-bit wire buffer, and one device step computes π and
Tajima's D per panel and Hudson direct / grouped / 3-π Fst per pair
(``scanstep.scan_step``), with ``--ehh`` the EHH decay areas at a focal
variant, with ``--afs`` the per-panel allele frequency spectra, and with
``--identity-mode columns`` column-weighted identity; windows flagged
``seed_risk`` re-run their grouped Fst exactly.

``tajd``: S, pica2-grouped π per site and Tajima's D per window, from allele
tiles (``--geno-dir`` / ``--gfa-dir``, all windows padded into one batch)
or from one memory-mapped ``[N, S]`` matrix streamed through the device in
site chunks (``--stream-npy``).

The per-statistic commands ``pi``, ``hfst``, ``hud -m direct|grouped``,
``fst3pi``, ``panels-hfst`` and ``panels-tajd`` read one similarity matrix
per window (``--sim-dir`` TSVs, allele tiles through ``GenoSimSource``, or
``impg`` with ``--use-impg``) and compute the windows of the BED in device
batches of ``_WINDOW_CHUNK_ELEMS`` sim elements (128 windows at N = 512);
``afs`` clusters one similarity TSV into allele classes.

``ehh``: EHH decay areas at a focal site per window, from a haplotype
matrix (``-i``) or from allele tiles at ``--focal`` positions, on the EHH
kernel in device batches; areas count active sites only, so a ragged or
padded window gives the reference script's area.  ``sfs``: per-window,
per-panel spectra from allele tiles and their genome-wide sum.  The
host-only commands ``spectrum``, ``extract``, ``gfasim``, ``gfa2vcf``,
``import-agc``, ``merge-parts``, ``makewindows`` and ``plot`` live in
``impop_tpu_torch.hostcmds`` and take no ``--device``.

Several devices: ``scan --device cuda`` deals whole batches to the local
GPUs in turn (``scanstep.deal_wire``); ``scan --distributed`` gives each
process of a ``torch.distributed`` group its contiguous share of the
windows and ``.partK`` outputs (``merge-parts`` joins them);
``hfst`` / ``hud --pair-shard on`` split the pair space of a device batch
of windows over the local devices (``parallel.pairspace``).
"""
from __future__ import annotations

import argparse
import collections
import concurrent.futures as futures
import functools
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from impop_tpu_torch import hostcmds
from impop_tpu_torch.hostio import (DirSimSource, GenoSource, GfaDirSource,
                                    ImpgSimSource, SimilarityMatrix,
                                    SimSource, WindowError, _add_common,
                                    _add_sim_args, _capacity_for,
                                    _load_windows, _open_extractor,
                                    _out_stream, _panel_label,
                                    _print_counters, _resolve_fasta,
                                    _scan_buf_layout, _warn,
                                    _write_window_log, expand_population,
                                    pack_scan_batch, parse_region, read_bed,
                                    read_panel_file, read_similarity_tsv,
                                    round_half_even, site_weights_from_keys,
                                    split_multiallelic, tables)
from impop_tpu_torch.runtime.journal import ResultJournal
from impop_tpu_torch.runtime.profiling import (StageTimers, count,
                                               device_trace, span)

__all__ = ["build_parser", "cmd_scan", "cmd_tajd", "cmd_pi", "cmd_hfst",
           "cmd_hud", "cmd_fst3pi", "cmd_afs", "cmd_panels_hfst",
           "cmd_panels_tajd", "cmd_sfs", "cmd_ehh", "emit_batch",
           "GenoSimSource", "main"]


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
    q = len(pair_list)

    def cols(name: str, k: int) -> list:
        return rows[:, lay[name]:lay[name] + k].astype(np.float64).tolist()

    n_v = rows[:, lay["n"]].astype(np.int64).tolist()
    s_v = rows[:, lay["s"]].astype(np.int64).tolist()
    pi_v, d_v = cols("pi", p_count), cols("d", p_count)
    fst_v, fstg_v, f3_v = cols("fst", q), cols("fstg", q), cols("f3", q)
    if ehh_focal_pos is not None:
        # [area_ref, area_alt, carriers_ref, carriers_alt]
        area_v = cols("ehh", 2)
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
        # each window's spectrum, sparse in its journal record so that a
        # resumed scan still merges it (allele count 0 is never meaningful)
        with span("emit.afs"):
            # the counts are exact integers in float32: [W, P, bins]
            hist = rows[:, lay["afs"]:].reshape(w, p_count, -1)[:, :, 1:]
            hist = hist.astype(np.int64).reshape(w, -1)
            afs_total[:, 1:] += hist.sum(axis=0).reshape(p_count, -1)
            if records is None:
                count("afs.bins_emitted", np.count_nonzero(hist))
            else:
                # window-major, then panel, then count: each window's run
                # of nonzero bins in the journal's order
                at = np.flatnonzero(hist)
                count("afs.bins_emitted", at.size)
                per_w = hist.shape[1]
                keys = _afs_keys(p_count, per_w // p_count)[
                    at % per_w].tolist()
                vals = hist.ravel()[at].tolist()
                ends = np.searchsorted(at, per_w * np.arange(1, w + 1))
                lo = 0
                for rec, hi in zip(records, ends.tolist()):
                    rec["afs"] = dict(zip(keys[lo:hi], vals[lo:hi]))
                    lo = hi
    if records is not None:
        journal.record_many(zip((rs for _, rs in kept), records))
        count("journal.writes")
    out.write("".join(ln + "\n" for ln in lines))


def _open_device(name: str):
    """The one device of a single-device command: ``cuda`` is the current
    GPU, as the JAX commands take the default device."""
    from impop_tpu_torch.device import resolve_device

    return resolve_device(name)


def cmd_scan(args) -> int:
    """Fused scan with a result journal for idempotent resume.

    Whole batches are dealt to the local devices in turn (``--device
    cuda``: every GPU; ``cuda:K`` or ``cpu``: that one): batch k runs on
    device k mod D, so each batch costs one host enqueue of the step
    however many GPUs there are, and its rows come back to the host from
    its own device.  With ``--distributed`` each process scans its
    contiguous share of the windows (``host_window_range``) into
    ``<file>.partK`` outputs for ``merge-parts``.

    The call's spans and counters (``runtime/profiling.py``) are recorded
    on the main thread and on the two workers of the host pipeline
    (``extract``, ``build``), and written by ``--timing-json``."""
    timers = StageTimers()
    with timers.bound("main"):
        return _scan(args, timers)


def _scan(args, timers: StageTimers) -> int:
    from impop_tpu_torch.device import on_device
    from impop_tpu_torch.parallel.distributed import (finalize,
                                                      host_window_range,
                                                      maybe_initialize,
                                                      process_devices)
    from impop_tpu_torch.scanstep import (deal_wire, row_layout,
                                          rows_to_host, scan_step,
                                          scan_step_fstg_exact, step_event)

    rank, world = maybe_initialize(args.distributed)
    with span("setup"):
        devs = process_devices(args.device)
        if devs[0].type == "cuda":
            from impop_tpu_torch.ops._build import load_library

            with span("setup.build"):
                load_library()

        with span("setup.bed"):
            regions = read_bed(args.bed)
        if world > 1:
            lo, hi = host_window_range(len(regions), rank, world)
            regions = regions[lo:hi]
            for attr in ("output", "journal", "afs", "timing_json"):
                if getattr(args, attr, None):
                    setattr(args, attr, f"{getattr(args, attr)}.part{rank}")
        geno_src = (GenoSource(args.geno_dir) if args.geno_dir
                    else GfaDirSource(args.gfa_dir) if args.gfa_dir else None)
        with span("setup.open"):
            fasta_store = _resolve_fasta(args)
            extractor = (_open_extractor(args.paf, fasta_store)
                         if args.paf and fasta_store else None)
        # the native extractor's clock and counts: its open now, its batch
        # extractions at the end of the call
        native_stats = getattr(extractor, "stats", None)
        if native_stats is not None:
            for key, v in native_stats().items():
                if key.startswith("open.") or key == "extractors.open":
                    count(key, v)
        if geno_src is None and extractor is None:
            raise SystemExit("error: provide --geno-dir, --gfa-dir, "
                             "--paf + --fasta, or --paf + --agc")

        with span("setup.panels"):
            panel_files = sorted(args.panel or [])
            panel_names = [_panel_label(p) for p in panel_files]
            panel_lists = [read_panel_file(p) for p in panel_files]
        p_count = max(1, len(panel_lists))
        pair_list = [(i, j) for i in range(len(panel_lists))
                     for j in range(i + 1, len(panel_lists))]
        pair_key = tuple(pair_list)
        with_pairs = bool(pair_list)
        pair_a_np = np.asarray([i for i, _ in pair_list] or [0], np.int32)
        pair_b_np = np.asarray([j for _, j in pair_list] or [0], np.int32)
        thr = float(args.threshold)

        with span("setup.journal"):
            journal = ResultJournal(args.journal)

        use_weights = args.identity_mode == "columns"
        want_ehh = bool(args.ehh)
        want_afs = bool(args.afs)
        afs_bins = args.afs_bins
        afs_folded = not args.afs_unfolded
        afs_total = (np.zeros((p_count, afs_bins + 1), np.int64) if want_afs
                     else None)
        # a window holding an --ehh-focal position anchors its EHH focal there
        # instead of at the midpoint
        ehh_targets = _read_ehh_targets(args.ehh_focal if want_ehh else None)
        ehh_focal_pos: Dict[str, int] = {}   # region -> genomic position used

        def ehh_focal_index(reg, rs, pos_arr) -> int:
            """Focal column = the variant nearest the target position; the
            chosen position is recorded for the output row."""
            if pos_arr is None or len(pos_arr) == 0:
                return 0
            target = (reg.start + reg.end) // 2
            for pos in ehh_targets.get(reg.chrom, ()):
                if reg.start <= pos < reg.end:
                    target = pos
                    break
            pos_arr = np.asarray(pos_arr)
            fi = int(np.argmin(np.abs(pos_arr - target)))
            ehh_focal_pos[rs] = int(pos_arr[fi])
            return fi

        @functools.lru_cache(maxsize=64)
        def masks_for_stems(stems_key: tuple) -> np.ndarray:
            masks = np.zeros((p_count, len(stems_key)), dtype=bool)
            for pi_idx, plist in enumerate(panel_lists):
                matched, _ = expand_population(plist, list(stems_key))
                for k, nm in enumerate(stems_key):
                    if nm in matched:
                        masks[pi_idx, k] = True
            return masks

        def panel_masks_for(names_key: tuple) -> np.ndarray:
            # panel prefixes never reach into the ":start-end" range suffix of
            # extracted names, so one cache entry serves a contiguous scan
            return masks_for_stems(tuple(n.split(":", 1)[0]
                                         for n in names_key))

        # The native path's masks by row set, cached for the call (the build
        # worker is their only user).  A row set's key is the target and the
        # window's name blob with its reference row, the whole line equal to
        # its region string, blanked to a NUL line, which no name holds.  Two
        # windows of one key hold the same names at the same sorted positions
        # but that row, whose stem the target fixes, and membership is a
        # prefix test on the stem: their masks are equal.
        def row_set_key(tgt: str, blob: bytes, rs: str) -> Tuple[str, bytes]:
            ref = rs.encode()
            at = (b"\n" + blob).find(b"\n" + ref + b"\n")
            if at >= 0:
                blob = blob[:at] + b"\0" + blob[at + len(ref):]
            return tgt, blob

        @functools.lru_cache(maxsize=64)
        def row_set_masks(key: Tuple[str, bytes]) -> np.ndarray:
            tgt, blob = key
            names = blob.decode().splitlines()
            if "\0" in names:
                names[names.index("\0")] = tgt
            return panel_masks_for(tuple(names))

        header = ["REGION", "LENGTH", "SAMPLES", "SEGREGATING_SITES"]
        if panel_lists:
            for name in panel_names:
                header += [f"PI_{name}", f"TAJD_{name}"]
            for i, j in pair_list:
                header += [f"FST_{panel_names[i]}_{panel_names[j]}",
                           f"FSTG_{panel_names[i]}_{panel_names[j]}",
                           f"FST3_{panel_names[i]}_{panel_names[j]}"]
        else:
            header += ["PI", "TAJIMAS_D"]
        if want_ehh:
            header += ["EHH_FOCAL", "EHH_AREA_REF", "EHH_CARR_REF",
                       "EHH_AREA_ALT", "EHH_CARR_ALT"]
        lay = row_layout(p_count, len(pair_list), want_ehh)

        def disjoint_of(panels: np.ndarray) -> bool:
            return with_pairs and not bool(
                (panels[:, pair_a_np] & panels[:, pair_b_np]).any())

    out = _out_stream(args.output)
    try:
        print("\t".join(header), file=out)
        pending: List[Tuple[object, str]] = []
        for reg in regions:
            rs = reg.region_string(args.prefix)
            rec = journal.get(rs)
            if rec is not None and "row" in rec:
                print(rec["row"], file=out)
                if want_afs:
                    sparse = rec.get("afs")
                    if sparse is None:
                        _warn(f"Warning: journal row for {rs} predates "
                              "--afs; spectrum will miss it")
                    else:
                        for pk, c in sparse.items():
                            pi_idx, k = map(int, pk.split(":"))
                            afs_total[pi_idx, k] += int(c)
                continue
            pending.append((reg, rs))

        batch_size = args.batch
        cap_hint = [64, 128]  # [n, s] shape floors, grown per chunk

        def load_chunk(chunk):
            tiles, kept, failures = [], [], []
            for reg, rs in chunk:
                try:
                    if geno_src is not None:
                        g, names, keys = geno_src.load(rs)
                        g, keys = split_multiallelic(
                            np.asarray(g, np.int8), keys)
                    else:
                        wm = extractor.extract(rs.rsplit(":", 1)[0],
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

        def extract_native(chunk, batch):
            """One C++ call per target-contiguous window group; returns open
            native batch handles the build worker packs from."""
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

        def prepare_native(extracted, n_chunks, dev, batch):
            """Wire-pack straight from the native batches' memory + H2D to
            ``dev``."""
            groups, batches = extracted
            with span("build", batch=batch, cpu=True):
                failures, kept, rows = [], [], []
                for gi, ((_tgt, items), nb) in enumerate(zip(groups,
                                                            batches)):
                    for k, (reg, rs) in enumerate(items):
                        if nb.errors[k]:
                            failures.append((rs, nb.errors[k]))
                        else:
                            kept.append((reg, rs))
                            rows.append((gi, k))
                if not kept:
                    for nb in batches:
                        nb.close()
                    return None, kept, failures, False, (0, 0)
                n_max = max(max((n for n, _ in nb.dims), default=1)
                            for nb in batches)
                s_max = max(max((s for _, s in nb.dims), default=1)
                            for nb in batches)
                cap_n = _capacity_for([max(cap_hint[0], n_max)])
                cap_s = ((max(cap_hint[1], s_max, 128) + 127) // 128) * 128
                cap_hint[0] = max(cap_hint[0], cap_n)
                cap_hint[1] = max(cap_hint[1], cap_s)
                w = batch_size if n_chunks > 1 else len(kept)
                blay = _scan_buf_layout(cap_n, cap_s, p_count, use_weights,
                                        want_ehh)
                flat = np.zeros((w, blay["total"]), np.uint8)
                row_of = {key: wi for wi, key in enumerate(rows)}
                with span("build.pack"):
                    for gi, nb in enumerate(batches):
                        nb.pack_into(
                            flat, [row_of.get((gi, k), -1)
                                   for k in range(nb.count)],
                            cap_n, cap_s, blay["m"], blay["sm"],
                            blay["w"] if use_weights else -1)
                panels = np.zeros((w, p_count, cap_n), bool)
                lengths = np.zeros(w, np.uint32)
                lengths[:len(kept)] = [reg.length for reg, _ in kept]
                focals = np.zeros(w, np.uint32)
                by_row_set: dict = {}   # key -> buffer rows
                for wi, ((gi, k), (reg, rs)) in enumerate(zip(rows, kept)):
                    nb = batches[gi]
                    if want_ehh:
                        focals[wi] = ehh_focal_index(reg, rs, nb.site_pos(k))
                    if not panel_lists:
                        panels[wi, 0, :nb.dims[k][0]] = True
                        continue
                    key = row_set_key(groups[gi][0], nb.names_blob(k), rs)
                    by_row_set.setdefault(key, []).append(wi)
                if panel_lists:
                    misses = row_set_masks.cache_info().misses
                    for key, wis in by_row_set.items():
                        m = row_set_masks(key)
                        panels[np.asarray(wis), :, :m.shape[1]] = m
                    resolved = row_set_masks.cache_info().misses - misses
                    count("masks.resolved_windows", resolved)
                    count("masks.cached_windows", len(kept) - resolved)
                for nb in batches:
                    nb.close()
                flat[:, blay["p"]:blay["l"]] = np.packbits(
                    panels, axis=-1, bitorder="little").reshape(w, -1)
                flat[:, blay["l"]:blay["l"] + 4] = (
                    lengths.astype("<u4").view(np.uint8).reshape(w, 4))
                if want_ehh:
                    flat[:, blay["f"]:blay["f"] + 4] = (
                        focals.astype("<u4").view(np.uint8).reshape(w, 4))
                disjoint = disjoint_of(panels)
            with span("h2d", batch=batch):
                wire = deal_wire(flat, dev)
            return wire, kept, failures, disjoint, (cap_n, cap_s)

        def prepare_tiles(extracted, n_chunks, dev, batch):
            """Pad + fused pack + H2D to ``dev`` for tiles from
            --geno-dir/--gfa-dir or the per-window extractor; padding
            windows are all-zero rows (no members, length 0) and come out
            inert."""
            tiles, kept, failures = extracted
            if not tiles:
                return None, kept, failures, False, (0, 0)
            with span("build", batch=batch, cpu=True):
                cap_n = _capacity_for([t0.shape[0] for t0, *_ in tiles])
                cap_s = max(128, max(t0.shape[1] for t0, *_ in tiles))
                cap_s = ((cap_s + 127) // 128) * 128
                w = batch_size if n_chunks > 1 else len(tiles)
                geno = np.full((w, cap_n, cap_s), -1, dtype=np.int8)
                member = np.zeros((w, cap_n), bool)
                smask = np.zeros((w, cap_s), bool)
                panels = np.zeros((w, p_count, cap_n), bool)
                lengths = np.zeros(w, np.float32)
                wts = np.ones((w, cap_s), np.float32)
                focals = np.zeros(w, np.uint32) if want_ehh else None
                for wi, ((g, names, keys), (reg, rs)) in enumerate(
                        zip(tiles, kept)):
                    n, s = g.shape
                    geno[wi, :n, :s] = g
                    member[wi, :n] = True
                    smask[wi, :s] = True
                    lengths[wi] = reg.length
                    if use_weights and keys is not None:
                        wts[wi, :s] = site_weights_from_keys(keys)
                    if want_ehh:
                        pos = ([int(k.split(":", 1)[0]) for k in keys]
                               if keys is not None else None)
                        focals[wi] = ehh_focal_index(reg, rs, pos)
                    if panel_lists:
                        panels[wi, :, :n] = panel_masks_for(tuple(names))
                    else:
                        panels[wi, 0, :n] = True
                disjoint = disjoint_of(panels)
                flat = pack_scan_batch(geno, member, smask, panels, lengths,
                                       wts, use_weights, focals)
            with span("h2d", batch=batch):
                wire = deal_wire(flat, dev)
            return wire, kept, failures, disjoint, (cap_n, cap_s)

        native_path = (geno_src is None and extractor is not None
                       and hasattr(extractor, "extract_batch_open"))

        def extract_stage(chunk, batch):
            if native_path:
                return extract_native(chunk, batch)
            with span("extract", batch=batch):
                return load_chunk(chunk)

        def prepare_stage(fx, k):
            """Chunk k, whole, goes to device k mod D: the deal depends on
            the chunk's index alone, not on thread timing."""
            prep = prepare_native if native_path else prepare_tiles
            return prep(fx.result(), len(chunks), devs[k % len(devs)], k)

        # two-stage host pipeline: chunk k+1 extracts on one worker while
        # chunk k packs + copies on the other and the devices compute the
        # chunks before it; at least two prepared batches, and one per
        # device, are in flight
        chunks = [pending[lo:lo + batch_size]
                  for lo in range(0, len(pending), batch_size)]
        pool_x = futures.ThreadPoolExecutor(
            max_workers=1, initializer=timers.bind, initargs=("extract",))
        pool_b = futures.ThreadPoolExecutor(
            max_workers=1, initializer=timers.bind, initargs=("build",))
        inflight: collections.deque = collections.deque()  # (k, future)
        next_submit = 0
        depth = max(2, len(devs))

        def top_up():
            nonlocal next_submit
            while next_submit < len(chunks) and len(inflight) < depth:
                fx = pool_x.submit(extract_stage, chunks[next_submit],
                                   next_submit)
                inflight.append((next_submit, pool_b.submit(
                    prepare_stage, fx, next_submit)))
                next_submit += 1

        n_done = n_failed = 0

        def exact_fstg(packed, kept, wire, caps, k):
            """Windows flagged seed_risk re-run their grouped Fst through
            the exact first-found-pair program, on their batch's device;
            only their FSTG changes."""
            if not with_pairs:
                return packed
            risk = np.nonzero(packed[:len(kept), lay["risk"]] > 0)[0]
            if risk.size == 0:
                return packed
            with span("device.exact", batch=k), on_device(wire.device):
                exact = scan_step_fstg_exact(
                    wire, caps[0], caps[1], p_count, pair_key, thr,
                    rows=[int(r) for r in risk], use_weights=use_weights,
                    use_ehh=want_ehh).cpu().numpy()
            packed = packed.copy()
            packed[risk, lay["fstg"]:lay["f3"]] = exact
            return packed

        def drain(metas):
            """Emit a group's batches in chunk order; rows past a batch's
            kept windows (the padding of a short last chunk) are never
            read."""
            nonlocal n_done
            for k, began, (host, done), kept_b, wire_b, caps_b in metas:
                with span("fetch", batch=k):
                    if done is not None:
                        done.synchronize()        # the barrier
                        count("step.gpu_ns",
                              round(began.elapsed_time(done) * 1e6))
                    packed_b = host.numpy()
                packed_b = exact_fstg(packed_b, kept_b, wire_b, caps_b, k)
                with span("emit", batch=k):
                    timers.add_windows(len(kept_b))
                    emit_batch(packed_b, kept_b, lay, panel_names, pair_list,
                               out, journal,
                               ehh_focal_pos if want_ehh else None,
                               afs_total, args.log_dir, args.threshold)
                n_done += len(kept_b)

        # grouped drains: each batch's rows are copied to the host from its
        # own device as soon as its step is queued (no tensor moves between
        # devices); every drain_group batches the host waits for and emits
        # the group before, so the devices compute while it drains
        drain_group = max(1, int(args.drain_group or 4))
        group: list = []    # [(k, began, (host, done), kept, wire, caps)]
        pending_out = None      # the group before, drained next

        def flush_group():
            nonlocal pending_out, group
            if not group:
                return
            if pending_out is not None:
                drain(pending_out)
            pending_out, group = group, []

        with device_trace(args.profile_dir, timers):
            try:
                top_up()
                while inflight:
                    k, prepared = inflight.popleft()
                    with span("wait_input", batch=k):
                        (wire, kept, failures, disjoint,
                         caps) = prepared.result()
                    top_up()
                    for rs, err in failures:
                        _warn(f"Warning: {rs}: {err}; recording NA")
                        journal.record_failure(rs, err)
                        n_failed += 1
                    if wire is None:
                        continue
                    with span("device", batch=k, cpu=True), \
                            on_device(wire.device):
                        began = step_event(wire.device)
                        out_dev = scan_step(
                            wire, caps[0], caps[1], p_count, pair_key, thr,
                            disjoint, use_weights, want_ehh, want_afs,
                            afs_bins, afs_folded)
                        fetched = rows_to_host(out_dev)
                    group.append((k, began, fetched, kept, wire, caps))
                    if len(group) >= drain_group:
                        flush_group()
                flush_group()
                if pending_out is not None:
                    drain(pending_out)
            finally:
                pool_x.shutdown(wait=True, cancel_futures=True)
                pool_b.shutdown(wait=True, cancel_futures=True)
        if native_stats is not None:
            for key, v in native_stats().items():
                if key.startswith("extract."):
                    count(key, v)
        _print_counters(n_done, n_failed)
    finally:
        if out is not sys.stdout:
            out.close()
    if want_afs:
        _write_afs(args.afs, afs_total, panel_names)
        _warn(f"wrote genome-wide spectrum -> {args.afs}")
    if args.verbose_timing:
        _warn(timers.report())
    if args.timing_json:
        import json

        with open(args.timing_json, "w") as fh:
            json.dump(timers.to_json(), fh)
    if args.distributed:
        finalize()
    return 0


def _tajd_log(args, rs, length, n_val, s_val, pi_val, d_val, **extra):
    _write_window_log(args.log_dir, rs, "Tajima's D Calculation",
                      {"region": rs, "length": int(length),
                       "threshold": args.threshold, "n": n_val,
                       "segregating_sites": s_val, "pi_per_site": pi_val,
                       "tajimas_d": "NA" if np.isnan(d_val) else d_val,
                       **extra})


def _tajd_streamed(args, regions, dev) -> int:
    """One window of any length: a memory-mapped [N, S] int8 .npy streamed
    through the device in site chunks (runtime/sitestream.py).  Rows are
    padded to the batched path's capacity, so both paths reduce the same
    shapes and print the same row."""
    from impop_tpu_torch.runtime.sitestream import SiteStreamAccumulator

    if len(regions) != 1:
        raise SystemExit("error: --stream-npy processes exactly one window "
                         f"(BED has {len(regions)} rows)")
    reg = regions[0]
    rs = reg.region_string(args.prefix)
    geno = np.load(args.stream_npy, mmap_mode="r")
    if geno.ndim != 2:
        raise SystemExit("error: --stream-npy must be a 2-D [N, S] matrix")
    n_rows, s_total = geno.shape

    names = None
    if args.stream_names:
        names = read_panel_file(args.stream_names)
        if len(names) != n_rows:
            raise SystemExit(f"error: {len(names)} names for {n_rows} rows")
    # deterministic seed order = sorted sequence-name row order
    order = np.argsort(names) if names is not None else np.arange(n_rows)
    # S and the counts cover ALL rows (run_tajd.sh:148); -s restricts only
    # the grouped-π membership, as the batched path's panel mask does
    cap_n = _capacity_for([n_rows])
    member = np.zeros(cap_n, bool)
    member[:n_rows] = True
    pi_member = None
    if args.samples:
        if names is None:
            raise SystemExit("error: -s filtering needs --stream-names")
        sorted_names = [names[i] for i in order]
        matched, _ = expand_population(read_panel_file(args.samples),
                                       sorted_names)
        pi_member = np.zeros(cap_n, bool)
        pi_member[:n_rows] = [nm in matched for nm in sorted_names]

    length = args.length or reg.length
    chunk = max(128, args.chunk_sites)
    acc = SiteStreamAccumulator(member, chunk_s=chunk, device=dev)
    tile = np.full((cap_n, chunk), -1, np.int8)
    for lo in range(0, s_total, chunk):
        part = geno[order, lo:lo + chunk]
        tile[:n_rows, :part.shape[1]] = part
        acc.update(tile[:, :part.shape[1]])
    st = acc.finalize(float(length), args.threshold, pi_member=pi_member)

    n_val, s_val = int(st.n), int(st.s)
    pi_val, d_val = float(st.pi_site), float(st.d)
    out = _out_stream(args.output)
    try:
        print(tables.TAJD_HEADER, file=out)
        print(tables.tajd_row(rs, int(length), n_val, s_val, pi_val, d_val),
              file=out)
    finally:
        if out is not sys.stdout:
            out.close()
    if args.log_dir:
        _tajd_log(args, rs, length, n_val, s_val, pi_val, d_val,
                  site_chunks=(s_total + chunk - 1) // chunk)
    return 0


def cmd_tajd(args) -> int:
    """Segregating sites, grouped π and Tajima's D per window, in device
    batches of at most ``_WINDOW_CHUNK_ELEMS`` sim elements."""
    dev = _open_device(args.device)
    regions = read_bed(args.bed)
    # panels-tajd passes a namespace without the streaming flags
    if getattr(args, "stream_npy", None):
        return _tajd_streamed(args, regions, dev)
    gfa_dir = getattr(args, "gfa_dir", None)
    if not args.geno_dir and not gfa_dir:
        raise SystemExit("error: provide --geno-dir or --gfa-dir")
    geno_src = (GenoSource(args.geno_dir) if args.geno_dir
                else GfaDirSource(gfa_dir))
    samples = getattr(args, "samples", None)
    sample_list = read_panel_file(samples) if samples else None

    kept, tiles, region_strings = [], [], []
    n_err = 0
    for reg in regions:
        rs = reg.region_string(args.prefix)
        try:
            tiles.append(geno_src.load(rs))
        except WindowError as e:
            _warn(f"Warning: {e}; skipping window")
            n_err += 1
            continue
        kept.append(reg)
        region_strings.append(rs)
    _print_counters(len(kept), n_err)

    out = _out_stream(args.output)
    try:
        print(tables.TAJD_HEADER, file=out)
        if not kept:
            return 0
        # every batch is padded to the capacity of the largest window, so a
        # window's row does not depend on the batch it falls in
        cap_n = _capacity_for([t[0].shape[0] for t in tiles])
        cap_s = max(8, max(t[0].shape[1] for t in tiles))
        cap_s = ((cap_s + 127) // 128) * 128
        step = max(1, _WINDOW_CHUNK_ELEMS // (cap_n * cap_n))
        for lo in range(0, len(tiles), step):
            _tajd_batch(args, tiles[lo:lo + step], kept[lo:lo + step],
                        region_strings[lo:lo + step], sample_list, cap_n,
                        cap_s, dev, out)
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def _tajd_batch(args, tiles, kept, region_strings, sample_list, cap_n,
                cap_s, dev, out) -> None:
    """One device batch of ``cmd_tajd``: pad, run, print the rows (and
    their logs) in window order."""
    import torch

    from impop_tpu_torch.parallel.scan import batch_tajd_from_alleles

    w = len(tiles)
    geno = np.full((w, cap_n, cap_s), -1, dtype=np.int8)
    member = np.zeros((w, cap_n), dtype=bool)
    site_mask = np.zeros((w, cap_s), dtype=bool)
    panels = np.zeros((w, 1, cap_n), dtype=bool)
    lengths = np.zeros((w,), dtype=np.float32)
    for wi, ((g, names, _keys), reg) in enumerate(zip(tiles, kept)):
        order = np.argsort(names)
        names = [names[i] for i in order]
        n, s = g.shape
        geno[wi, :n, :s] = g[order]
        member[wi, :n] = True
        site_mask[wi, :s] = True
        lengths[wi] = args.length or reg.length
        if sample_list is None:
            panels[wi, 0, :n] = True
        else:
            matched, _ = expand_population(sample_list, names)
            panels[wi, 0, :n] = [nm in matched for nm in names]
    res = batch_tajd_from_alleles(
        *(torch.from_numpy(a).to(dev)
          for a in (geno, member, site_mask, panels, lengths)),
        args.threshold)
    n_h, s_h, pi_h, d_h = (t.cpu().numpy()
                           for t in (res.n, res.s, res.pi, res.d))
    for wi, rs in enumerate(region_strings):
        n_val, s_val = int(n_h[wi, 0]), int(s_h[wi])
        pi_val, d_val = float(pi_h[wi, 0]), float(d_h[wi, 0])
        print(tables.tajd_row(rs, int(lengths[wi]), n_val, s_val,
                              pi_val, d_val), file=out)
        if args.log_dir:
            _tajd_log(args, rs, lengths[wi], n_val, s_val, pi_val, d_val)


# ------------------------------------------------------------ sim sources


class GenoSimSource(SimSource):
    """Identity matrices from allele tiles (``.npz`` windows, ``.gfa``
    graphs or native PAF + FASTA extraction), with the arguments of
    ``impop_tpu.cli.GenoSimSource`` plus ``device`` (the card unless the
    caller asks for ``"cpu"``; raises without CUDA).

    The integer difference and comparison counts are computed on
    ``device`` by ``stats.allele.pairwise_diff`` (fp32 ``torch.matmul``
    with TF32 off, as the JAX package leaves these counts to XLA); the
    host divides ``1 − diff / length`` in float64 and
    rounds half to even (``-r``), exactly as the JAX package does, so
    rounded similarities match digit for digit.  ``identity_mode``
    "columns" weighs an indel of k bases as k differences.
    """

    def __init__(self, round_digits: Optional[int],
                 geno_dir: Optional[str] = None,
                 paf: Optional[str] = None, fasta: Optional[str] = None,
                 use_native: bool = True, gfa_dir: Optional[str] = None,
                 identity_mode: str = "events", device="cuda"):
        from impop_tpu_torch.device import resolve_device

        self.round_digits = round_digits
        self.identity_mode = identity_mode
        self.device = resolve_device(device)
        self.geno_src = (GenoSource(geno_dir) if geno_dir
                         else GfaDirSource(gfa_dir) if gfa_dir else None)
        self.extractor = None
        if paf and fasta:
            self.extractor = _open_extractor(paf, fasta, use_native)

    def load(self, region: str) -> SimilarityMatrix:
        import torch

        from impop_tpu_torch.stats.allele import pairwise_diff

        reg = parse_region(region)
        if self.geno_src is not None:
            geno, names, site_keys = self.geno_src.load(region)
        elif self.extractor is not None:
            wm = self.extractor.extract(reg.chrom, reg.start, reg.end)
            geno, names, site_keys = wm.geno, wm.names, wm.site_keys
        else:
            raise WindowError(f"no allele source for region {region}")
        order = np.argsort(names)
        geno = np.asarray(geno, dtype=np.int8)[order]
        names = [names[i] for i in order]
        n, s = geno.shape
        length = max(reg.length, 1)

        weights = None
        if self.identity_mode == "columns":
            if site_keys is None:
                _warn(f"Warning: no site keys for {region}; "
                      "columns identity falls back to events")
            else:
                weights = site_weights_from_keys(site_keys)

        cap_n = _capacity_for([n])
        cap_s = max(8, ((s + 127) // 128) * 128)
        g = np.full((cap_n, cap_s), -1, dtype=np.int8)
        g[:n, :s] = geno
        member = np.zeros(cap_n, bool)
        member[:n] = True
        smask = np.zeros(cap_s, bool)
        smask[:s] = True
        w = None
        if weights is not None:
            w = np.zeros(cap_s, np.float32)
            w[:s] = weights
        num_alleles = int(geno.max(initial=1)) + 1
        dev = self.device
        diff_d, compared_d = pairwise_diff(
            *(torch.from_numpy(a).to(dev) for a in (g, member, smask)),
            num_alleles, None if w is None else torch.from_numpy(w).to(dev))
        diff = diff_d.cpu().numpy().astype(np.float64)[:n, :n]
        compared = compared_d.cpu().numpy().astype(np.float64)[:n, :n]
        sim = 1.0 - diff / length
        present = compared > 0
        np.fill_diagonal(present, True)
        sim = np.where(present, sim, 0.0)
        np.fill_diagonal(sim, 1.0)
        if self.round_digits is not None:
            sim = round_half_even(sim, self.round_digits)
        return SimilarityMatrix(names=names, sim=sim, present=present,
                                pair_count=n * (n - 1) // 2)


def _make_sim_source(args, dev) -> SimSource:
    mode = getattr(args, "identity_mode", "events")
    if getattr(args, "sim_dir", None):
        return DirSimSource(args.sim_dir, args.round)
    if getattr(args, "geno_dir", None):
        return GenoSimSource(args.round, geno_dir=args.geno_dir,
                             identity_mode=mode, device=dev)
    if getattr(args, "gfa_dir", None):
        return GenoSimSource(args.round, gfa_dir=args.gfa_dir,
                             identity_mode=mode, device=dev)
    if getattr(args, "paf", None):
        if getattr(args, "agc", None) and getattr(args, "use_impg", False):
            return ImpgSimSource(args.paf, args.agc, args.round,
                                 getattr(args, "subset", None))
        fasta = _resolve_fasta(args)
        if fasta:
            return GenoSimSource(args.round, paf=args.paf, fasta=fasta,
                                 identity_mode=mode, device=dev)
    raise SystemExit(
        "error: provide --sim-dir (per-window TSVs), --geno-dir (allele "
        "tiles), --paf + --fasta / --paf + --agc (native extraction), or "
        "--paf + --agc --use-impg (external impg compat)")


# ------------------------------------------------------------ batches

# sim elements per device batch of the per-statistic commands: bounds the
# [w, N, N] sim / present tiles and the grouping temporaries of a batch
_WINDOW_CHUNK_ELEMS = 1 << 25


def _batched(mats, panels, dev, run, exact=False) -> List[np.ndarray]:
    """``run(batch)`` over the windows in device batches of at most
    ``_WINDOW_CHUNK_ELEMS`` sim elements, all padded to the capacity of the
    largest window; each output's column 0 for every window, on the host."""
    from impop_tpu_torch.runtime.batcher import build_window_batch

    cap = _capacity_for([m.n for m in mats])
    step = max(1, _WINDOW_CHUNK_ELEMS // (cap * cap))
    parts = []
    for lo in range(0, len(mats), step):
        batch, _ = build_window_batch(mats[lo:lo + step], panels,
                                      capacity=cap, exact_names=exact,
                                      device=dev)
        parts.append([t[:, 0].cpu().numpy() for t in run(batch)])
    return [np.concatenate(f) for f in zip(*parts)]


# ------------------------------------------------------------ pi


def cmd_pi(args) -> int:
    """run_pica2_impg.sh: pica2 π per window, optionally of one panel."""
    from impop_tpu_torch.parallel.scan import batch_pi_panels
    from impop_tpu_torch.runtime.batcher import PanelSet

    dev = _open_device(args.device)
    regions = read_bed(args.bed)
    src = _make_sim_source(args, dev)
    kept, mats, region_strings = _load_windows(regions, src, args.prefix)
    if not kept:
        _warn("Warning: no windows could be processed")

    subset_label = os.path.basename(args.subset) if args.subset else None
    panels = (PanelSet.from_dict({"S": tuple(read_panel_file(args.subset))})
              if args.subset else None)

    out = _out_stream(args.output)
    try:
        print(tables.pi_table_header(subset_label is not None), file=out)
        if not kept:
            return 0
        pi, n_v, groups_v, used_v, miss_v = _batched(
            mats, panels, dev, lambda b: batch_pi_panels(
                b.sim, b.present, b.member, b.panels, args.threshold))
        for wi, reg in enumerate(kept):
            length = args.length or reg.length
            pica = tables.format_pica_output(
                float(pi[wi]), float(pi[wi]) / length, length)
            print(tables.pi_row(region_strings[wi], subset_label, length,
                                args.threshold, args.round, pica), file=out)
            if args.log_dir:
                _write_window_log(
                    args.log_dir, region_strings[wi],
                    "Nucleotide Diversity Analysis Log",
                    {"region": region_strings[wi],
                     "threshold": args.threshold,
                     "round_digits": args.round,
                     "n": int(n_v[wi]),
                     "groups": int(groups_v[wi]),
                     "group_pairs_with_data": int(used_v[wi]),
                     "group_pairs_missing": int(miss_v[wi]),
                     "pi": float(pi[wi]),
                     "pi_per_site": float(pi[wi]) / length})
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


# ------------------------------------------------------------ hudson fst


def _two_panels(args):
    from impop_tpu_torch.runtime.batcher import PanelSet

    return PanelSet.from_dict({"A": tuple(read_panel_file(args.pop_a)),
                               "B": tuple(read_panel_file(args.pop_b))})


def _load_geno_windows(args, regions):
    """Allele-tile windows (geno, sorted names) for the pair-shard path."""
    geno_src = (GenoSource(args.geno_dir)
                if getattr(args, "geno_dir", None) else None)
    extractor = None
    if geno_src is None:
        fasta_store = _resolve_fasta(args)
        if args.paf and fasta_store:
            extractor = _open_extractor(args.paf, fasta_store)
    if geno_src is None and extractor is None:
        return None
    kept, tiles, rss = [], [], []
    for reg in regions:
        rs = reg.region_string(args.prefix)
        try:
            if geno_src is not None:
                g, names, _ = geno_src.load(rs)
            else:
                wm = extractor.extract(rs.rsplit(":", 1)[0],
                                       reg.start, reg.end)
                g, names = wm.geno, wm.names
        except Exception as e:
            print(f"Warning: skipping window {rs}: {e}", file=sys.stderr)
            continue
        order = np.argsort(names)
        tiles.append((np.asarray(g, np.int8)[order],
                      [names[i] for i in order]))
        kept.append(reg)
        rss.append(rs)
    return kept, tiles, rss


def _run_hudson_pair_sharded(args, devs, force: bool) -> Optional[int]:
    """Direct-method Hudson with the pair space split by row blocks over
    the local devices (``parallel.pairspace``): each device forms only its
    [N/D, N] block of pairwise differences and the partial sums merge on
    the first device, so the [N, N] identity exists nowhere.  The table
    and its float64 host derivations are the replicated path's; only the
    f32 summation order differs.

    The windows go in device batches, one call and one host read each.
    Returns None when ``force`` is False and every window is below the
    sharding threshold (the caller takes the replicated batch path).
    """
    import torch

    from impop_tpu_torch.parallel.mesh import make_mesh
    from impop_tpu_torch.parallel.pairspace import pair_sharded_direct_stats

    regions = read_bed(args.bed)
    loaded = _load_geno_windows(args, regions)
    if loaded is None:
        if force:
            raise SystemExit("error: --pair-shard on needs an allele "
                             "source (--geno-dir or --paf + --fasta/--agc)")
        return None
    kept, tiles, region_strings = loaded
    max_n = max((g.shape[0] for g, _ in tiles), default=0)
    if not force and max_n < 1024:
        return None

    if getattr(args, "round", None) is not None:
        _warn("Warning: --pair-shard computes masked pair sums without "
              "materialising per-pair similarities, so -r rounding does "
              "not apply (use the replicated path for -r parity)")
    n_dev = len(devs)
    pair_fn = pair_sharded_direct_stats(make_mesh(data=n_dev, devices=devs))
    pop_a = read_panel_file(args.pop_a)
    pop_b = read_panel_file(args.pop_b)

    # every window padded to shared caps: rows to a multiple of the
    # devices, sites to the lane width
    cap_n = _capacity_for([max_n])
    cap_n = ((cap_n + n_dev - 1) // n_dev) * n_dev
    cap_s = max(128, max((g.shape[1] for g, _ in tiles), default=1))
    cap_s = ((cap_s + 127) // 128) * 128
    # one call a device batch: at most _WINDOW_CHUNK_ELEMS int8 cells, and
    # as many elements of each device's [W, N/D, N] pair block
    step = max(1, _WINDOW_CHUNK_ELEMS // max(cap_n * cap_s,
                                             cap_n // n_dev * cap_n))

    def selection(names):
        if args.exact_names:
            in_a, in_b = set(pop_a), set(pop_b)
            return (np.asarray([nm in in_a for nm in names], bool),
                    np.asarray([nm in in_b for nm in names], bool))
        m_a, _ = expand_population(pop_a, names)
        m_b, _ = expand_population(pop_b, names)
        return (np.asarray([nm in m_a for nm in names], bool),
                np.asarray([nm in m_b for nm in names], bool))

    out = _out_stream(args.output)
    try:
        print(tables.HFST_HEADER, file=out)
        for lo in range(0, len(kept), step):
            batch = range(lo, min(lo + step, len(kept)))
            w = len(batch)
            gp = np.full((w, cap_n, cap_s), -1, np.int8)
            member = np.zeros((w, cap_n), bool)
            smask = np.zeros((w, cap_s), bool)
            mask_a = np.zeros((w, 1, cap_n), bool)
            mask_b = np.zeros((w, 1, cap_n), bool)
            lengths = np.zeros(w, np.float32)
            for wi, k in enumerate(batch):
                g, names = tiles[k]
                n, s = g.shape
                gp[wi, :n, :s] = g
                member[wi, :n] = True
                smask[wi, :s] = True
                sel_a, sel_b = selection(names)
                overlap = sel_a & sel_b      # h-fst.py:181-185 strip
                mask_a[wi, 0, :n] = sel_a & ~overlap
                mask_b[wi, 0, :n] = sel_b & ~overlap
                lengths[wi] = kept[k].length
            res = pair_fn(gp, member, smask, mask_a, mask_b, lengths)
            # one host read a device batch
            sums = torch.stack([r[:, 0] for r in res[:3]]).cpu().numpy()
            for wi, k in enumerate(batch):
                reg, rs = kept[k], region_strings[k]
                pi_a, pi_b, dxy = (float(v) for v in sums[:, wi])
                pi_xy = 0.5 * (pi_a + pi_b)
                fst = (dxy - pi_xy) / dxy if dxy > 0 else 0.0
                da = dxy - pi_xy
                inv = 1.0 / reg.length
                print(tables.hfst_row(
                    rs, reg.length, fst,
                    pi_a * inv, pi_b * inv, pi_xy * inv, dxy * inv, da * inv,
                ), file=out)
                if args.log_dir:
                    _write_window_log(
                        args.log_dir, rs, "FST Calculation",
                        {"region": rs, "method": "direct (pair-sharded)",
                         "devices": n_dev,
                         "pi_a": pi_a, "pi_b": pi_b, "pi_xy": pi_xy,
                         "dxy": dxy, "fst": fst, "da": da,
                         "per_site_length": reg.length})
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def _run_hudson(args, grouped: bool) -> int:
    """run_h-fst.sh / run_hud.sh: Hudson Fst of panels A and B per window,
    direct or grouped; Fst and Da from the f32 sums in float64 on the
    host.  ``--pair-shard on`` (or ``auto`` with several local devices and
    1024 haplotypes or more) takes the direct method through the pair-space
    split over the local devices."""
    from impop_tpu_torch.device import local_devices
    from impop_tpu_torch.parallel.scan import batch_hudson

    ps_mode = getattr(args, "pair_shard", "off")
    if ps_mode != "off" and not grouped:
        devs = local_devices(args.device)
        if ps_mode == "on" or len(devs) > 1:
            done = _run_hudson_pair_sharded(args, devs,
                                            force=(ps_mode == "on"))
            if done is not None:
                return done
    elif ps_mode == "on" and grouped:
        raise SystemExit("error: --pair-shard supports the direct method "
                         "only (the grouped estimators need the global "
                         "[N, N] grouping recurrence)")
    dev = _open_device(args.device)
    regions = read_bed(args.bed)
    src = _make_sim_source(args, dev)
    kept, mats, region_strings = _load_windows(regions, src, args.prefix)

    out = _out_stream(args.output)
    try:
        print(tables.HFST_HEADER, file=out)
        if not kept:
            return 0
        def run(b):
            res = batch_hudson(b.sim, b.present, b.member, b.panels, (0,),
                               (1,), args.threshold, with_grouped=grouped)
            chosen = res.grouped if grouped else res.direct
            return chosen.pi_a, chosen.pi_b, chosen.dxy

        pi_a_v, pi_b_v, dxy_v = (
            v.astype(np.float64) for v in _batched(
                mats, _two_panels(args), dev, run, exact=args.exact_names))
        for wi, reg in enumerate(kept):
            length = reg.length
            pi_a, pi_b, dxy = pi_a_v[wi], pi_b_v[wi], dxy_v[wi]
            pi_xy = 0.5 * (pi_a + pi_b)
            fst = (dxy - pi_xy) / dxy if dxy > 0 else 0.0
            da = dxy - pi_xy
            inv = 1.0 / length
            print(tables.hfst_row(
                region_strings[wi], length, fst, pi_a * inv, pi_b * inv,
                pi_xy * inv, dxy * inv, da * inv), file=out)
            if args.log_dir:
                _write_window_log(
                    args.log_dir, region_strings[wi], "FST Calculation",
                    {"region": region_strings[wi],
                     "method": "grouped" if grouped else "direct",
                     "pi_a": pi_a, "pi_b": pi_b, "pi_xy": pi_xy,
                     "dxy": dxy, "fst": fst, "da": da,
                     "per_site_length": length})
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def cmd_hfst(args) -> int:
    return _run_hudson(args, grouped=False)


def cmd_hud(args) -> int:
    return _run_hudson(args, grouped=(args.method == "grouped"))


# ------------------------------------------------------------ 3-pi fst


def cmd_fst3pi(args) -> int:
    """run_fst_impg.sh: πA, πB, πC of A ∪ B and the 3-π Fst per window."""
    from impop_tpu_torch.parallel.scan import batch_fst_3pi_panels

    dev = _open_device(args.device)
    regions = read_bed(args.bed)
    src = _make_sim_source(args, dev)
    kept, mats, region_strings = _load_windows(regions, src, args.prefix)

    out = _out_stream(args.output)
    try:
        print(tables.FST3PI_HEADER, file=out)
        if not kept:
            return 0
        def run(b):
            res = batch_fst_3pi_panels(b.sim, b.present, b.member, b.panels,
                                       (0,), (1,), args.threshold)
            return res.pi_a, res.pi_b, res.pi_c

        pa_v, pb_v, pc_v = _batched(mats, _two_panels(args), dev, run,
                                    exact=args.exact_names)
        for wi, reg in enumerate(kept):
            length = reg.length
            pi_a = float(pa_v[wi]) / length
            pi_b = float(pb_v[wi]) / length
            pi_c = float(pc_v[wi]) / length
            print(tables.fst3pi_row(region_strings[wi], length,
                                    args.threshold, args.round, pi_a, pi_b,
                                    pi_c), file=out)
            if args.log_dir:
                pi_ab = 0.5 * (pi_a + pi_b)
                _write_window_log(
                    args.log_dir, region_strings[wi], "3-pi FST Calculation",
                    {"region": region_strings[wi], "length": length,
                     "threshold": args.threshold,
                     "pi_a": pi_a, "pi_b": pi_b, "pi_c": pi_c,
                     "pi_ab": pi_ab,
                     "fst": ((pi_c - pi_ab) / pi_c if pi_c else "NA")})
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


# ------------------------------------------------------------ afs


def cmd_afs(args) -> int:
    """af.py: the allele classes of one similarity TSV, the connected
    components of ``sim >= threshold``, with sizes and frequencies."""
    import torch

    from impop_tpu_torch.stats.grouping import label_components

    dev = _open_device(args.device)
    # af.py truncates identifiers at the first ':' (af.py:13-14)
    mat = read_similarity_tsv(args.input)
    short = [nm.split(":", 1)[0] for nm in mat.names]
    uniq = sorted(set(short))
    idx = {nm: i for i, nm in enumerate(uniq)}
    n = len(uniq)
    sim = np.zeros((n, n))
    present = np.zeros((n, n), dtype=bool)
    np.fill_diagonal(present, True)
    np.fill_diagonal(sim, 1.0)
    for i in range(mat.n):
        for j in range(mat.n):
            if i != j and mat.present[i, j]:
                a, b = idx[short[i]], idx[short[j]]
                sim[a, b] = (max(sim[a, b], mat.sim[i, j])
                             if present[a, b] and a != b else mat.sim[i, j])
                present[a, b] = True

    cap = _capacity_for([n])
    sim_p = np.zeros((cap, cap), dtype=np.float32)
    sim_p[:n, :n] = sim
    pres_p = np.zeros((cap, cap), dtype=bool)
    pres_p[:n, :n] = present
    member = np.zeros(cap, dtype=bool)
    member[:n] = True
    # af.py links pairs with value >= threshold (af.py:38)
    adj = (sim_p >= args.threshold) & pres_p
    labels = label_components(torch.from_numpy(adj).to(dev),
                              torch.from_numpy(member).to(dev))
    labels = labels.cpu().numpy()[:n]

    groups: Dict[int, List[str]] = {}
    for i, name in enumerate(uniq):
        groups.setdefault(int(labels[i]), []).append(name)
    clusters = sorted(groups.values(), key=lambda c: (-len(c), sorted(c)))

    out = _out_stream(args.output)
    try:
        print(tables.AFS_HEADER, file=out)
        for row in tables.afs_summary_rows(clusters):
            print(row, file=out)
    finally:
        if out is not sys.stdout:
            out.close()
    if args.details:
        with open(args.details, "w") as fh:
            fh.write("sample_id\tcluster_id\tthreshold\n")
            for ci, members in enumerate(clusters, 1):
                for sname in sorted(members):
                    fh.write(f"{sname}\tc{ci}\t{args.threshold}\n")
    return 0


# ------------------------------------------------------------ batches


def cmd_panels_hfst(args) -> int:
    """All 10 unordered continental pairs (run_h_fst_panels.sh:60-71),
    each written to ``<a>.<b>.fst`` in the working directory."""
    pairs = [("EUR", "AFR"), ("EAS", "AFR"), ("SAS", "AFR"), ("AMR", "AFR"),
             ("EAS", "EUR"), ("SAS", "EUR"), ("AMR", "EUR"), ("EAS", "SAS"),
             ("AMR", "SAS"), ("AMR", "EAS")]
    for a, b in pairs:
        sub = argparse.Namespace(**vars(args))
        sub.pop_a = os.path.join(args.metadata_dir, f"agc.{a}")
        sub.pop_b = os.path.join(args.metadata_dir, f"agc.{b}")
        sub.output = f"{a.lower()}.{b.lower()}.fst"
        if not (os.path.exists(sub.pop_a) and os.path.exists(sub.pop_b)):
            _warn(f"Warning: missing panel list for {a} or {b}; skipping")
            continue
        print(f"[h-fst] {a} vs {b} -> {sub.output}", file=sys.stderr)
        cmd_hfst(sub)
    return 0


def cmd_panels_tajd(args) -> int:
    """The 5 continental panels (run_tajd_panels.sh:60-66), each written
    to ``<panel>.tj`` in the working directory."""
    panels = [("EUR", "eur.tj"), ("AFR", "afr.tj"), ("EAS", "eas.tj"),
              ("SAS", "sas.tj"), ("AMR", "amr.tj")]
    for group, output in panels:
        sub = argparse.Namespace(**vars(args))
        sub.samples = os.path.join(args.metadata_dir, f"agc.{group}")
        sub.output = output
        if not os.path.exists(sub.samples):
            _warn(f"Warning: missing panel list for {group}; skipping")
            continue
        print(f"[tajd] {group} -> {output}", file=sys.stderr)
        cmd_tajd(sub)
    return 0


# ------------------------------------------------------------ sfs


def cmd_sfs(args) -> int:
    """Per-window, per-panel site-frequency spectra from allele tiles and
    their genome-wide sum (the JAX ``sfs``): ``stats/allele.panel_afs`` over
    device batches of at most ``_WINDOW_CHUNK_ELEMS`` (window, panel, row,
    site) cells, summed in int64 on the device and fetched once."""
    import torch

    from impop_tpu_torch.stats.allele import panel_afs

    dev = _open_device(args.device)
    regions = read_bed(args.bed)
    geno_src = (GenoSource(args.geno_dir) if args.geno_dir
                else GfaDirSource(args.gfa_dir) if args.gfa_dir else None)
    fasta_store = _resolve_fasta(args)
    extractor = (_open_extractor(args.paf, fasta_store)
                 if args.paf and fasta_store else None)
    if geno_src is None and extractor is None:
        raise SystemExit("error: provide --geno-dir, --gfa-dir, "
                         "--paf + --fasta, or --paf + --agc")

    panel_files = sorted(args.panel or [])
    panel_names = [_panel_label(p) for p in panel_files] or ["ALL"]
    panel_lists = [read_panel_file(p) for p in panel_files]
    p_count = len(panel_names)

    kept, tiles = [], []
    for reg in regions:
        rs = reg.region_string(args.prefix)
        try:
            if geno_src is not None:
                g, names, _keys = geno_src.load(rs)
            else:
                wm = extractor.extract(rs.rsplit(":", 1)[0],
                                       reg.start, reg.end)
                g, names = wm.geno, wm.names
        except Exception as e:
            _warn(f"Warning: {rs}: {e}; skipping window")
            continue
        order = np.argsort(names)
        tiles.append((np.asarray(g, np.int8)[order],
                      [names[i] for i in order]))
        kept.append((reg, rs))

    out = _out_stream(args.output)
    try:
        if not kept:
            _warn("Warning: no windows could be processed")
            print("ALLELE_COUNT\t" +
                  "\t".join(f"SITES_{n}" for n in panel_names), file=out)
            return 0
        # capacities and bins over all windows: the table does not depend
        # on the batch size
        cap_n = _capacity_for([t[0].shape[0] for t in tiles])
        cap_s = max(8, ((max(t[0].shape[1] for t in tiles) + 127) // 128)
                    * 128)
        max_n = args.max_n or cap_n
        folded = not args.unfolded
        step = max(1, _WINDOW_CHUNK_ELEMS // (p_count * cap_n * cap_s))
        merged = torch.zeros((p_count, max_n + 1), dtype=torch.int64,
                             device=dev)
        per_win = []
        for lo in range(0, len(tiles), step):
            part = tiles[lo:lo + step]
            w = len(part)
            geno = np.full((w, cap_n, cap_s), -1, dtype=np.int8)
            member = np.zeros((w, cap_n), bool)
            smask = np.zeros((w, cap_s), bool)
            panels = np.zeros((w, p_count, cap_n), bool)
            for wi, (g, names) in enumerate(part):
                n, s = g.shape
                geno[wi, :n, :s] = g
                member[wi, :n] = True
                smask[wi, :s] = True
                if not panel_lists:
                    panels[wi, :, :n] = True
                for pi_idx, plist in enumerate(panel_lists):
                    matched, _ = expand_population(plist, names)
                    panels[wi, pi_idx, :n] = [nm in matched for nm in names]
            spectra = panel_afs(
                *(torch.from_numpy(a).to(dev)
                  for a in (geno, member, smask, panels)), max_n, folded)
            merged += spectra.sum(0, dtype=torch.int64)
            if args.per_window:
                per_win.append(spectra)
        merged = merged.cpu().numpy()  # [P, K]

        print("ALLELE_COUNT\t" +
              "\t".join(f"SITES_{n}" for n in panel_names), file=out)
        top = max_n // 2 if folded else max_n
        for k in range(1, top + 1):
            if merged[:, k].any() or k <= (args.max_n or 0):
                print(f"{k}\t" + "\t".join(str(int(merged[pi, k]))
                                           for pi in range(p_count)),
                      file=out)
    finally:
        if out is not sys.stdout:
            out.close()

    if args.per_window:
        per_win = torch.cat(per_win).cpu().numpy()
        with open(args.per_window, "w") as fh:
            fh.write("REGION\tPANEL\tALLELE_COUNT\tSITES\n")
            for wi, (reg, rs) in enumerate(kept):
                for pi_idx, pname in enumerate(panel_names):
                    hist = per_win[wi, pi_idx]
                    for k in np.nonzero(hist)[0]:
                        if k == 0:
                            continue
                        fh.write(f"{rs}\t{pname}\t{k}\t{int(hist[k])}\n")
    return 0


# ------------------------------------------------------------ ehh


def _ehh_areas(tiles, compat: bool, dev) -> Tuple[np.ndarray, np.ndarray]:
    """``stats/ehh.ehh_area_batch`` for each (tile [n, s] int8 0/1, focal
    column): tiles padded with masked columns and non-member rows to the
    largest, in device batches of at most ``_WINDOW_CHUNK_ELEMS`` int8
    cells, one EHH kernel launch a batch.  Steps count active sites only,
    so the padding and the batch size change no area.  Returns (area
    [W, 2] float32, carriers [W, 2] int32) on the host."""
    import torch

    from impop_tpu_torch.stats.ehh import ehh_area_batch

    n_cap = max(t.shape[0] for t, _ in tiles)
    s_cap = max(t.shape[1] for t, _ in tiles)
    step = max(1, _WINDOW_CHUNK_ELEMS // (n_cap * s_cap))
    areas, carriers = [], []
    for lo in range(0, len(tiles), step):
        part = tiles[lo:lo + step]
        w = len(part)
        geno = np.zeros((w, n_cap, s_cap), np.int8)
        member = np.zeros((w, n_cap), bool)
        smask = np.zeros((w, s_cap), bool)
        focal = np.zeros(w, np.int64)
        for row, (t, fi) in enumerate(part):
            n, s = t.shape
            geno[row, :n, :s] = t
            member[row, :n] = True
            smask[row, :s] = True
            focal[row] = fi
        area, carr = ehh_area_batch(
            *(torch.from_numpy(a).to(dev)
              for a in (geno, member, smask, focal)),
            compat_right_for_left=compat)
        areas.append(area.cpu().numpy())
        carriers.append(carr.cpu().numpy())
    return np.concatenate(areas), np.concatenate(carriers)


def _ehh_from_tiles(args, dev) -> int:
    """Extraction mode: each ``--focal P`` takes the BED window holding P
    and the variant column nearest P in its allele tile (``--geno-dir``, or
    extracted with ``--paf`` + ``--fasta`` / ``--agc``).  Each tile keeps
    its own focal column (no re-centring, unlike the JAX command, whose
    shared centre makes a focal's area depend on the other focals).
    Output row: ``region focal_pos site_pos site_key allele REF|ALT
    carriers area`` (allele 0 = the reference allele of the column)."""
    if not args.bed or not args.focal:
        raise SystemExit("error: extraction mode needs -b and --focal "
                         "(or pass -i for matrix mode)")
    regions = read_bed(args.bed)
    geno_src = GenoSource(args.geno_dir) if args.geno_dir else None
    extractor = None
    if geno_src is None:
        fasta_store = _resolve_fasta(args)
        if args.paf and fasta_store:
            extractor = _open_extractor(args.paf, fasta_store)
    if geno_src is None and extractor is None:
        raise SystemExit("error: provide --geno-dir or --paf + "
                         "--fasta/--agc")

    tasks = []
    for fp in args.focal:
        reg = next((r for r in regions if r.start <= fp < r.end), None)
        if reg is None:
            _warn(f"Warning: no BED window contains focal {fp}; skipping")
            continue
        tasks.append((reg, reg.region_string(args.prefix), fp))

    tiles, kept = [], []
    for reg, rs, fp in tasks:
        try:
            if geno_src is not None:
                g, names, keys = geno_src.load(rs)
                if keys is None:
                    raise WindowError("allele tile has no site_keys — "
                                      "positions unavailable")
                pos = np.asarray([int(k.split(":", 1)[0]) for k in keys])
            else:
                wm = extractor.extract(rs.rsplit(":", 1)[0],
                                       reg.start, reg.end)
                g, pos, keys = wm.geno, np.asarray(wm.site_pos), wm.site_keys
        except Exception as e:
            _warn(f"Warning: skipping focal {fp} ({rs}): {e}")
            continue
        if len(pos) == 0:
            _warn(f"Warning: no variants in {rs}; skipping focal {fp}")
            continue
        fi = int(np.argmin(np.abs(pos - fp)))
        kept.append((rs, fp, int(pos[fi]), keys[fi]))
        # alt carrier = 1; reference call and uncovered both binarise to 0
        tiles.append(((np.asarray(g) == 1).astype(np.int8), fi))
    out = _out_stream(args.output)
    try:
        if kept:
            area, carriers = _ehh_areas(tiles, bool(args.compat_ehhgfa), dev)
            for row, (rs, fp, used_pos, key) in enumerate(kept):
                for ai, al in enumerate((0, 1)):
                    if carriers[row, ai] == 0:
                        continue
                    typeal = "REF" if al == 0 else "ALT"
                    print(rs, fp, used_pos, key, al, typeal,
                          int(carriers[row, ai]), float(area[row, ai]),
                          file=out, flush=True)
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def cmd_ehh(args) -> int:
    """EHH decay areas around a focal SNP (the JAX ``ehh``).

    Matrix mode (``-i``): a whitespace-separated haplotype matrix without
    header, non-zero entries binarised to 1, cut into windows of ``-w``
    sites; for each allele at site ``-p`` of a window it prints ``window
    colstart colend allele REF|ALT area`` (REF/ALT from row ``--refpos``).
    The ragged last window is the columns it has: unlike the JAX command,
    which pads it and counts the padding as EHH steps, its area is the
    reference script's.  Without ``-i``: extraction mode
    (:func:`_ehh_from_tiles`).  ``--compat-ehhgfa`` uses the right half for
    both directions, as the reference script does.
    """
    dev = _open_device(args.device)
    if not args.input:
        return _ehh_from_tiles(args, dev)
    if args.position is None or args.window is None:
        raise SystemExit("error: matrix mode needs -i, -p and -w")
    whole = np.loadtxt(args.input)
    if whole.ndim == 1:
        whole = whole[None, :]
    whole = (whole != 0).astype(np.int8)
    total_sites = whole.shape[1]
    test_snp = args.position - 1
    wsize = args.window

    starts = list(range(0, total_sites, wsize))
    keep = [(wi, cs) for wi, cs in enumerate(starts)
            if min(cs + wsize, total_sites) - cs > test_snp]
    out = _out_stream(args.output)
    try:
        if keep:
            area, carriers = _ehh_areas(
                [(whole[:, cs:cs + wsize], test_snp) for _, cs in keep],
                bool(args.compat_ehhgfa), dev)
            for row, (wi, cs) in enumerate(keep):
                ce = min(cs + wsize, total_sites)
                ref_allele = int(whole[args.refpos - 1, cs + test_snp])
                for ai, al in enumerate((0, 1)):
                    if carriers[row, ai] == 0:
                        continue  # allele absent at the focal site
                    typeal = "REF" if al == ref_allele else "ALT"
                    print(wi + 1, cs, ce, al, typeal,
                          float(area[row, ai]), file=out, flush=True)
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def _add_device(p) -> None:
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without CUDA; scan and "
                        "--pair-shard take every local GPU), cuda:K or "
                        "cpu (the plain PyTorch path)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="impop-tpu-torch",
        description="impop on PyTorch (CUDA kernels on the GPU)")
    sub = ap.add_subparsers(dest="command", required=True)
    p = sub.add_parser("scan", help="fused pi+Fst+TajD scan with resume")
    p.add_argument("-b", "--bed", required=True)
    p.add_argument("--geno-dir", help="directory of per-window .npz tiles")
    p.add_argument("--gfa-dir", help="directory of per-window .gfa graphs")
    p.add_argument("--paf")
    p.add_argument("--fasta")
    p.add_argument("--agc", help="AGC archive (one-time cached conversion "
                                 "to a BGZF FASTA store)")
    p.add_argument("--agc-bin", default="agc")
    p.add_argument("--identity-mode", choices=["events", "columns"],
                   default="events",
                   help="identity deviation spec: 'events' (one per "
                        "variant) or 'columns' (an indel of k bases "
                        "counts k)")
    p.add_argument("--afs", help="write the genome-wide per-panel allele "
                                 "frequency spectrum to this file")
    p.add_argument("--afs-bins", type=int, default=512,
                   help="largest allele count binned (--afs)")
    p.add_argument("--afs-unfolded", action="store_true",
                   help="alt-allele counts instead of folded minor counts")
    p.add_argument("--ehh", action="store_true",
                   help="add EHH decay areas and carrier counts for both "
                        "alleles at a focal variant per window")
    p.add_argument("--ehh-focal",
                   help="'chrom pos' lines: a window holding one takes the "
                        "nearest variant as its EHH focal (default: the "
                        "variant nearest the midpoint)")
    p.add_argument("--panel", action="append", default=[],
                   help="panel list file (repeatable, e.g. metadata/agc.EUR)")
    p.add_argument("-P", "--prefix", default="CHM13#0#")
    p.add_argument("-t", "--threshold", type=float, default=0.999)
    p.add_argument("-o", "--output")
    p.add_argument("--journal", help="JSONL journal path for resume")
    p.add_argument("--batch", type=int, default=320,
                   help="windows per device step")
    p.add_argument("--drain-group", type=int, default=4,
                   help="device batches whose rows the host waits for "
                        "and emits at once, one group behind the front")
    p.add_argument("--distributed", action="store_true",
                   help="multi-host: join the gloo process group from "
                        "torchrun's environment (MASTER_ADDR, MASTER_PORT, "
                        "RANK, WORLD_SIZE) and scan this rank's contiguous "
                        "share of the windows into <file>.partK outputs")
    _add_device(p)
    p.add_argument("--profile-dir",
                   help="write a torch.profiler Chrome trace to this "
                        "directory")
    p.add_argument("--verbose-timing", action="store_true",
                   help="print per-stage wall times to stderr")
    p.add_argument("--timing-json",
                   help="write the per-stage timing breakdown to this JSON")
    p.add_argument("-d", "--log-dir", default=None,
                   help="directory for per-window debug logs")
    p.set_defaults(func=cmd_scan)

    p = sub.add_parser("tajd", help="segregating sites + pi + Tajima's D")
    p.add_argument("-b", "--bed", required=True)
    p.add_argument("-P", "--prefix", default="CHM13#0#")
    p.add_argument("-t", "--threshold", type=float, default=0.999)
    p.add_argument("-o", "--output")
    p.add_argument("-r", "--round", type=int, default=None,
                   help="accepted as by the JAX tajd, which does not round")
    p.add_argument("-d", "--log-dir", default=None,
                   help="directory for per-window debug logs")
    p.add_argument("--geno-dir",
                   help="directory of per-window allele tiles (.npz)")
    p.add_argument("--gfa-dir",
                   help="directory of per-window variation graphs (.gfa)")
    p.add_argument("-l", "--length", type=int)
    p.add_argument("-s", "--samples", help="sample list file")
    p.add_argument("--stream-npy",
                   help="one window of any length: memory-mapped [N, S] "
                        "int8 .npy allele matrix streamed through the "
                        "device in site chunks (the BED must have exactly "
                        "one row)")
    p.add_argument("--stream-names",
                   help="sequence names for --stream-npy rows (one per "
                        "line, required with -s)")
    p.add_argument("--chunk-sites", type=int, default=4096,
                   help="site-chunk width for --stream-npy (default 4096)")
    _add_device(p)
    p.set_defaults(func=cmd_tajd)

    # the per-statistic commands: the JAX parser's flags, plus --device
    p = sub.add_parser("pi", help="nucleotide diversity window scan")
    _add_common(p)
    _add_sim_args(p)
    p.add_argument("-u", "--subset", help="panel list file (like agc.EUR)")
    p.add_argument("-l", "--length", type=int,
                   help="override per-site normalisation length")
    _add_device(p)
    p.set_defaults(func=cmd_pi)

    for name, fn in (("hfst", cmd_hfst), ("hud", cmd_hud),
                     ("fst3pi", cmd_fst3pi)):
        p = sub.add_parser(name)
        _add_common(p)
        _add_sim_args(p)
        p.add_argument("-A", "--pop-a", required=True)
        p.add_argument("-B", "--pop-b", required=True)
        p.add_argument("--exact-names", action="store_true",
                       help="panel lists contain exact sequence names "
                            "(hud.py matching) instead of assembly ids "
                            "(h-fst.py prefix matching)")
        if name == "hud":
            p.add_argument("-m", "--method", choices=["direct", "grouped"],
                           default="direct")
        if name in ("hfst", "hud"):
            p.add_argument("--pair-shard", choices=["auto", "on", "off"],
                           default="auto",
                           help="split the [N, N] pair space by row blocks "
                                "over the local devices (direct method, "
                                "allele sources only); auto = when N >= "
                                "1024 and more than one device is attached")
        _add_device(p)
        p.set_defaults(func=fn)

    p = sub.add_parser("afs", help="allele-class cluster frequencies (af.py)")
    p.add_argument("--input", default="loc.sim")
    p.add_argument("--threshold", type=float, default=1.0)
    p.add_argument("--output")
    p.add_argument("--details")
    _add_device(p)
    p.set_defaults(func=cmd_afs)

    p = sub.add_parser("panels-hfst", help="all 10 continental pair Fst runs")
    _add_common(p)
    _add_sim_args(p)
    p.add_argument("--metadata-dir", required=True)
    p.add_argument("--exact-names", action="store_true")
    _add_device(p)
    p.set_defaults(func=cmd_panels_hfst)

    p = sub.add_parser("panels-tajd", help="5 continental panel Tajima runs")
    _add_common(p)
    p.add_argument("--geno-dir")
    p.add_argument("--gfa-dir")
    p.add_argument("--metadata-dir", required=True)
    p.add_argument("-l", "--length", type=int)
    _add_device(p)
    p.set_defaults(func=cmd_panels_tajd)

    p = sub.add_parser("sfs", help="site-frequency spectrum from allele "
                                   "tiles (per-panel, genome-wide merge)")
    p.add_argument("-b", "--bed", required=True)
    p.add_argument("--geno-dir")
    p.add_argument("--gfa-dir")
    p.add_argument("--paf")
    p.add_argument("--fasta")
    p.add_argument("--agc")
    p.add_argument("--agc-bin", default="agc")
    p.add_argument("--panel", action="append", default=[],
                   help="panel list file (repeatable); default: all rows")
    p.add_argument("-P", "--prefix", default="CHM13#0#")
    p.add_argument("-o", "--output")
    p.add_argument("--unfolded", action="store_true",
                   help="derived-allele spectrum (default: folded minor)")
    p.add_argument("--max-n", type=int, default=None,
                   help="histogram bins (default: haplotype capacity)")
    p.add_argument("--per-window",
                   help="also write per-window spectra to this TSV")
    _add_device(p)
    p.set_defaults(func=cmd_sfs)

    p = sub.add_parser("ehh", help="EHH decay around a focal SNP (ehhgfa)")
    p.add_argument("-i", "--input",
                   help="haplotype matrix file (whitespace, no header); "
                        "omit to feed from allele tiles (--geno-dir or "
                        "--paf) with -b + --focal")
    p.add_argument("-p", "--position", type=int,
                   help="1-based focal SNP position within the window "
                        "(matrix mode)")
    p.add_argument("-w", "--window", type=int,
                   help="window width in sites (matrix mode)")
    p.add_argument("--refpos", type=int, default=1,
                   help="1-based reference haplotype row (matrix mode)")
    p.add_argument("-b", "--bed", help="window BED (extraction mode)")
    p.add_argument("-P", "--prefix", default="CHM13#0#")
    p.add_argument("--geno-dir",
                   help="directory of per-window allele tiles (.npz)")
    p.add_argument("--paf")
    p.add_argument("--fasta")
    p.add_argument("--agc", help="AGC archive (one-time cached conversion)")
    p.add_argument("--agc-bin", default="agc")
    p.add_argument("--focal", type=int, action="append",
                   help="genomic focal position (repeatable; extraction "
                        "mode picks the window containing it and the "
                        "nearest variant column)")
    p.add_argument("-o", "--output")
    p.add_argument("--compat-ehhgfa", action="store_true",
                   help="reproduce wip/ehhgfa.py's use of the right half "
                        "for both directions")
    _add_device(p)
    p.set_defaults(func=cmd_ehh)

    hostcmds.add_parsers(sub)
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
