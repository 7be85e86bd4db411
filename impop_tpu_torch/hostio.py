"""The port's host layer: the JAX-free helpers of ``impop_tpu/cli.py``,
copied, with ``impop_tpu_torch``'s own ``io``, ``extract`` and ``report``
in place of the JAX package's.

Each function computes exactly what its original does, so both packages
write one wire format, one row order (names are sorted before packing, and
the greedy seed order depends on it) and one table schema;
``tests/test_torch_hostio.py`` holds every copy against its original.
Nothing here imports ``jax`` or ``impop_tpu``
(``tests/test_torch_imports.py``).  Copied from ``impop_tpu/cli.py``:
lines 42-135 (sim sources), 243-270 (extractor and FASTA resolution),
297-421 (allele sources, capacity, window loading), 990-1004
(``_panel_label``), 1055-1119 (the scan's wire buffer) and 2652-2687 (the
shared arguments).
"""
from __future__ import annotations

import os
import subprocess
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from impop_tpu_torch.extract import site_weights_from_keys
from impop_tpu_torch.extract.simulate import simulate
from impop_tpu_torch.io.bed import Region, parse_region, read_bed
from impop_tpu_torch.io.panels import expand_population, read_panel_file
from impop_tpu_torch.io.simtsv import (SimilarityMatrix, read_similarity_tsv,
                                       round_half_even, write_similarity_tsv)
from impop_tpu_torch.report import tables

__all__ = ["DirSimSource", "GenoSource", "GfaDirSource", "ImpgSimSource",
           "SimSource", "WindowError", "tables", "_add_common",
           "_add_sim_args", "_capacity_for", "_load_windows",
           "_open_extractor", "_out_stream", "_panel_label",
           "_print_counters", "_resolve_fasta", "_scan_buf_layout",
           "_warn", "_write_window_log", "pack_scan_batch", "split_multiallelic",
           "simulate", "parse_region", "read_bed", "expand_population",
           "read_panel_file", "SimilarityMatrix", "read_similarity_tsv",
           "round_half_even", "write_similarity_tsv",
           "site_weights_from_keys"]


def _warn(msg: str) -> None:
    print(msg, file=sys.stderr)


def _write_window_log(log_dir: str, region: str, title: str, payload: dict) -> None:
    """Two-channel output contract (SURVEY.md §5): the TSV table goes to
    stdout/-o, per-window debug detail goes to a log directory — the
    reference writes step-by-step math to <input>.log (pica2.py:186-206,
    h-fst.py:323-335); ours is one human-readable + machine-parseable file
    per window."""
    import json

    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"{_sanitize(region)}.log")
    with open(path, "w") as fh:
        fh.write(f"{title}\n{'=' * len(title)}\n")
        for key, val in payload.items():
            fh.write(f"{key}: {val}\n")
        fh.write("\n" + json.dumps(payload) + "\n")


def _out_stream(path: Optional[str]):
    return open(path, "w") if path else sys.stdout


# --------------------------------------------------------------- sim sources


class WindowError(RuntimeError):
    pass


def _sanitize(region: str) -> str:
    return region.replace("#", "_").replace(":", "_").replace("-", "_")


class SimSource:
    """Resolve a region string to a SimilarityMatrix."""

    def load(self, region: str) -> SimilarityMatrix:
        raise NotImplementedError


class DirSimSource(SimSource):
    """Per-window TSVs in a directory.

    Tries ``<region>.sim``, ``<region>.tsv``, then sanitized variants
    (``#``/``:``/``-`` → ``_``).
    """

    def __init__(self, directory: str, round_digits: Optional[int]):
        self.directory = directory
        self.round_digits = round_digits

    def load(self, region: str) -> SimilarityMatrix:
        candidates = [
            f"{region}.sim", f"{region}.tsv",
            f"{_sanitize(region)}.sim", f"{_sanitize(region)}.tsv",
        ]
        for cand in candidates:
            path = os.path.join(self.directory, cand)
            if os.path.exists(path):
                return read_similarity_tsv(path, self.round_digits)
        raise WindowError(f"no similarity file for region {region} "
                          f"in {self.directory}")


class ImpgSimSource(SimSource):
    """Live extraction through an external ``impg`` binary (compat mode:
    exactly the reference's L1 call, run_pica2_impg.sh:162-168)."""

    def __init__(self, paf: str, agc: str, round_digits: Optional[int],
                 subset_list: Optional[str] = None):
        self.paf = paf
        self.agc = agc
        self.round_digits = round_digits
        self.subset_list = subset_list

    def load(self, region: str) -> SimilarityMatrix:
        cmd = ["impg", "similarity", "-p", self.paf, "-r", region,
               "--sequence-files", self.agc]
        if self.subset_list:
            cmd += ["--subset-sequence-list", self.subset_list]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=600)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise WindowError(f"impg similarity failed for {region}: {e}")
        if proc.returncode != 0:
            raise WindowError(f"impg similarity failed for {region}")
        import io as _io
        return read_similarity_tsv(_io.StringIO(proc.stdout),
                                   self.round_digits)


def _open_extractor(paf: str, fasta: str, use_native: bool = True):
    if use_native:
        try:
            from impop_tpu_torch.extract import NativeExtractor

            return NativeExtractor(paf, fasta)
        except Exception as e:  # no toolchain / build failure
            _warn(f"Warning: native extractor unavailable ({e}); "
                  "using Python fallback")
    from impop_tpu_torch.extract.pyfallback import PyExtractor

    return PyExtractor(paf, fasta)


def _resolve_fasta(args) -> Optional[str]:
    """--fasta, or --agc auto-converted once to a cached BGZF FASTA store
    (extract/agc.py) so AGC-format inputs run natively with no external impg
    (the reference shells to impg per window, run_pica2_impg.sh:162-168)."""
    fasta = getattr(args, "fasta", None)
    if fasta:
        return fasta
    agc = getattr(args, "agc", None)
    if agc:
        from impop_tpu_torch.extract.agc import ensure_fasta_store

        return ensure_fasta_store(agc, getattr(args, "agc_bin", "agc"))
    return None


class GenoSource:
    """Per-window allele tiles: ``<region>.npz`` with arrays ``geno``
    ([n, s] int8, -1 missing), ``names`` ([n] str) and optional
    ``site_keys`` ([s] str, "pos:ref>alt")."""

    def __init__(self, directory: str):
        self.directory = directory

    def load(self, region: str
             ) -> Tuple[np.ndarray, List[str], Optional[List[str]]]:
        for cand in (f"{region}.npz", f"{_sanitize(region)}.npz"):
            path = os.path.join(self.directory, cand)
            if os.path.exists(path):
                data = np.load(path, allow_pickle=False)
                names = [str(x) for x in data["names"]]
                keys = ([str(x) for x in data["site_keys"]]
                        if "site_keys" in data else None)
                return data["geno"].astype(np.int8), names, keys
        raise WindowError(f"no allele tile for region {region} "
                          f"in {self.directory}")


def split_multiallelic(geno: np.ndarray, keys: Optional[List[str]]
                       ) -> Tuple[np.ndarray, Optional[List[str]]]:
    """Normalise multiallelic tile columns to the native extractor's
    per-(pos, ref, alt) convention: a column with allele codes > 1 becomes
    one 0/1 indicator column per carried alt allele (carriers 1, other
    covered haplotypes 0, uncovered -1).

    The fused scan ships 2-bit biallelic codes over the wire
    (pack_scan_batch), but pica2's estimator is alphabet-agnostic
    (reference pica2.py:60-169) and ``--geno-dir`` tiles from other
    producers may carry codes {0, 1, 2, ...}.  Splitting reproduces
    exactly what the native extractor would have emitted for the same
    variation (each variant key its own column — doc/how_stats.md
    "Identity definition", deviation 2: two haplotypes with different alt
    alleles at one site differ at 2 matrix columns).  Split columns
    duplicate the source column's site key (same position, same indel
    weight).
    """
    if int(geno.max(initial=0)) <= 1:
        return geno, keys
    cols: List[np.ndarray] = []
    out_keys: Optional[List[str]] = [] if keys is not None else None
    for c in range(geno.shape[1]):
        col = geno[:, c]
        alts = np.unique(col[col > 0])
        if alts.size <= 1 and int(col.max(initial=0)) <= 1:
            cols.append(col)
            if out_keys is not None:
                out_keys.append(keys[c])
            continue
        valid = col >= 0
        for a in alts:
            cols.append(np.where(valid, (col == a).astype(np.int8),
                                 np.int8(-1)))
            if out_keys is not None:
                out_keys.append(keys[c])
    return np.stack(cols, axis=1), out_keys


class GfaDirSource:
    """Per-window variation graphs: ``<region>.gfa``, ingested through the
    graph path (impg query -o gfa → odgi → povu equivalents,
    run_pica2_odgi.sh:74-96) into the same allele tiles as GenoSource."""

    def __init__(self, directory: str, ref_path: Optional[str] = None):
        self.directory = directory
        self.ref_path = ref_path

    def load(self, region: str
             ) -> Tuple[np.ndarray, List[str], Optional[List[str]]]:
        from impop_tpu_torch.extract.gfa import alleles_from_gfa, read_gfa

        for cand in (f"{region}.gfa", f"{_sanitize(region)}.gfa"):
            path = os.path.join(self.directory, cand)
            if os.path.exists(path):
                wm, _ = alleles_from_gfa(read_gfa(path),
                                         ref_path=self.ref_path,
                                         include_ref_row=True)
                return wm.geno, wm.names, wm.site_keys
        raise WindowError(f"no window GFA for region {region} "
                          f"in {self.directory}")


# --------------------------------------------------------------- batching


def _capacity_for(n_values: Sequence[int], floor: int = 64) -> int:
    cap = max([floor] + list(n_values))
    # round up to a lane-friendly multiple
    m = 128 if cap > 64 else 64
    return ((cap + m - 1) // m) * m


def _load_windows(
    regions: Sequence[Region],
    src: SimSource,
    prefix: str,
) -> Tuple[List[Region], List[SimilarityMatrix], List[str]]:
    kept: List[Region] = []
    mats: List[SimilarityMatrix] = []
    region_strings: List[str] = []
    errors = 0
    for reg in regions:
        rs = reg.region_string(prefix)
        try:
            mats.append(src.load(rs))
        except WindowError as e:
            _warn(f"Warning: {e}; skipping window")
            errors += 1
            continue
        kept.append(reg)
        region_strings.append(rs)
    _print_counters(len(kept), errors)
    return kept, mats, region_strings


def _print_counters(ok: int, errors: int) -> None:
    """End-of-run success/error counters — the reference scripts keep and
    print these (run_h-fst.sh:151-203, run_pica2_impg.sh:168-180)."""
    _warn(f"Processed: {ok + errors} windows "
          f"(success: {ok}, errors: {errors})")


def _panel_label(path: str) -> str:
    """Panel column label from a panel-list filename.

    Reference panel lists are named ``agc.EUR`` (run_tajd_panels.sh:60-66) —
    the group is the last dot-component.  For conventionally-named files
    (``panA.txt``) the last component is a generic extension, so use the stem.
    """
    base = os.path.basename(path)
    parts = base.split(".")
    if len(parts) > 1 and parts[-1].lower() not in (
        "txt", "list", "tsv", "csv", "samples"
    ):
        return parts[-1]
    return parts[0]


def _scan_buf_layout(cap_n: int, cap_s: int, p_count: int,
                     use_weights: bool, use_ehh: bool = False
                     ) -> Dict[str, int]:
    """Byte offsets of the per-window fused input buffer.

    Segments: 2-bit allele codes, member bitmask, site bitmask, panel
    bitmasks, window length (uint32 LE), optional site weights (f32 LE —
    full precision: weights are indel base lengths and an integer wire
    type would silently clamp SVs > its range; 4*cap_s bytes is noise
    next to the geno segment), optional EHH focal column index
    (uint32 LE — `scan --ehh`).
    cap_n % 8 == 0 and cap_s % 128 == 0 by _capacity_for / cap rounding.
    """
    o_g = 0
    o_m = o_g + cap_n * (cap_s // 4)
    o_sm = o_m + cap_n // 8
    o_p = o_sm + cap_s // 8
    o_l = o_p + p_count * (cap_n // 8)
    o_w = o_l + 4
    o_f = o_w + (4 * cap_s if use_weights else 0)
    total = o_f + (4 if use_ehh else 0)
    return {"g": o_g, "m": o_m, "sm": o_sm, "p": o_p, "l": o_l, "w": o_w,
            "f": o_f, "total": total}


def pack_scan_batch(geno: np.ndarray, member: np.ndarray, smask: np.ndarray,
                    panels: np.ndarray, lengths: np.ndarray,
                    wts: Optional[np.ndarray],
                    use_weights: bool,
                    focals: Optional[np.ndarray] = None) -> np.ndarray:
    """Host-side fused pack -> [w, K] uint8 (layout: _scan_buf_layout).

    Runs on the prefetch worker thread; pure numpy, no device access.
    """
    w, cap_n, cap_s = geno.shape
    if geno.max(initial=-1) > 1:
        raise SystemExit("error: scan is biallelic (allele codes 0/1); "
                         "got a code > 1 in the allele tiles")
    # uint8 view + wrapping add: -1 -> 0, 0 -> 1, 1 -> 2 (no widening temp)
    codes = np.ascontiguousarray(geno).view(np.uint8) + np.uint8(1)
    c = codes.reshape(w, cap_n, -1, 4)
    g2 = c[..., 0].copy()
    g2 |= c[..., 1] << 2
    g2 |= c[..., 2] << 4
    g2 |= c[..., 3] << 6
    segs = [
        g2.reshape(w, -1),
        np.packbits(member, axis=-1, bitorder="little"),
        np.packbits(smask, axis=-1, bitorder="little"),
        np.packbits(panels, axis=-1, bitorder="little").reshape(w, -1),
        np.ascontiguousarray(lengths.astype(np.uint32)).view(np.uint8)
        .reshape(w, 4),
    ]
    if use_weights:
        segs.append(
            np.ascontiguousarray(wts.astype(np.float32))
            .view(np.uint8).reshape(w, -1)
        )
    if focals is not None:
        segs.append(
            np.ascontiguousarray(focals.astype(np.uint32))
            .view(np.uint8).reshape(w, 4)
        )
    return np.concatenate(segs, axis=1)


def _add_sim_args(p):
    p.add_argument("--sim-dir", help="directory of per-window similarity TSVs")
    p.add_argument("--geno-dir", help="directory of per-window allele tiles "
                                      "(.npz) to derive identities from")
    p.add_argument("--paf", help="PAF alignment file")
    p.add_argument("--fasta", help="FASTA sequence store "
                                   "(native extraction with --paf)")
    p.add_argument("--agc", help="AGC archive; auto-converted once to a "
                                 "cached BGZF FASTA store for native "
                                 "extraction (see import-agc)")
    p.add_argument("--agc-bin", default="agc",
                   help="agc binary used for the one-time conversion")
    p.add_argument("--use-impg", action="store_true",
                   help="with --paf + --agc: shell out to external impg per "
                        "window (reference compat) instead of converting")
    p.add_argument("--gfa-dir", help="directory of per-window variation "
                                     "graphs (<region>.gfa) to ingest")
    p.add_argument("--identity-mode", choices=["events", "columns"],
                   default="events",
                   help="native identity deviation spec (doc/how_stats.md): "
                        "'events' counts 1 per variant record; 'columns' "
                        "weighs indels by base length (alignment-column "
                        "semantics, closest to impg similarity)")


def _add_common(p):
    p.add_argument("-b", "--bed", required=True, help="BED file of windows")
    p.add_argument("-P", "--prefix", default="CHM13#0#",
                   help="region prefix (default: CHM13#0#)")
    p.add_argument("-o", "--output", help="output TSV (default: stdout)")
    p.add_argument("-t", "--threshold", type=float, default=0.999)
    p.add_argument("-r", "--round", type=int, default=None,
                   help="round similarities to N decimal places")
    p.add_argument("-d", "--log-dir", default=None,
                   help="directory for per-window debug logs")
