"""Variants of the masked sums and identity + grouping kernels, on the card.

    python -m impop_tpu_torch.bench.sums_group_variants

Builds variants of ``csrc/panelquad.cu`` and ``csrc/idgroup.cu`` (text
substitutions on the source or on a header it includes, each linked with
the unchanged ``windowstat.cu``, which holds the walk ``idgroup.cu``
launches and the error strings) and prints the device time of each whole
call (CUDA graph replays, median of 20) beside the base:

  masked_pair_sums  [512, 512] x 64 with 35 + 35 rows (values and 0/1, as
                    the columns scan) and x 128 with 2 + 2 0/1 rows (the
                    drivers); every checked variant's results must equal
                    the base's
    base      the kernel as built for the port
    occ2      two blocks per SM asked of the compiler at two tiles too
    ring8     a TMA ring of 8 chunks instead of 4 (csrc/rowprod.cuh)
    ring2     a ring of 2 chunks
    allpieces every tile takes all its piece products, 0/1 or not
    nomma     no wgmma products
    nodecode  no decode of sim / present into bf16 pieces
    nox       no loads and splits of the X rows after the first chunk
    nostore   no stores of Yd / Yp
              (the last four are wrong by design and not checked)
  identity_group    [512, 128] x 320, R = 15 (``bench.inputs``)
    base      the kernel as built for the port
    occ3      three blocks per SM asked of the compiler (pairs launch)
    orwords   present from 32 OR-ed words a lane at every site count (the
              form above kBitsMaxSites) instead of one bit a row
    smemrows  the 32 row words of each site word from the warp's mirror
              tile in shared memory (16-byte broadcast loads, no shuffles)
    notab     sim = 1 - d / len by IEEE division for every pair, not from
              the block's table of the same values
    nomirror  no stores of the mirror blocks (wrong by design, not checked)
    nostores  no sim / present stores at all (wrong by design)
"""
from __future__ import annotations

import ctypes
import os
import sys
import tempfile

_IG_LB = "__launch_bounds__(kThreads)\nidgroup_pairs_kernel"
_IG_MIRROR = "  for (int jj = 0; jj < 32; ++jj) {\n"
_IG_COUNTS = ("  typename impop::PresentForm<kBits>::type both;\n  int dn[32];\n"
              "  pair_counts(abits, vbits, n, SW, i0, j, lane, both, dn);\n")
_IG_FORM = "  const bool bits_form = s <= impop::kBitsMaxSites;\n"
_IG_SMEMROWS = """  uint32_t both = 0u;
  int dn[32];
#pragma unroll
  for (int ii = 0; ii < 32; ++ii) dn[ii] = 0;
  uint32_t* rows_a = reinterpret_cast<uint32_t*>(ts);   // [16, 32] words
  uint32_t* rows_v = rows_a + 16 * 32;
  for (int k0 = 0; k0 < SW; k0 += 16) {
    const int kn = min(16, SW - k0);
    __syncwarp();
    for (int kk = 0; kk < kn; ++kk) {
      const size_t ko = static_cast<size_t>(k0 + kk) * n;
      rows_a[kk * 32 + lane] = abits[ko + i0 + lane];
      rows_v[kk * 32 + lane] = vbits[ko + i0 + lane];
    }
    __syncwarp();
    for (int kk = 0; kk < kn; ++kk) {
      const size_t ko = static_cast<size_t>(k0 + kk) * n;
      const uint32_t aj = abits[ko + j], vj = vbits[ko + j];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const uint4 a4 = *reinterpret_cast<const uint4*>(rows_a + kk * 32 + 4 * q);
        const uint4 v4 = *reinterpret_cast<const uint4*>(rows_v + kk * 32 + 4 * q);
        const uint32_t av[4] = {a4.x, a4.y, a4.z, a4.w}, vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t bw = vv[e] & vj;
          both |= static_cast<uint32_t>(bw != 0u) << (4 * q + e);
          dn[4 * q + e] += __popc(bw & (av[e] ^ aj));
        }
      }
    }
  }
  __syncwarp();
"""
_IG_STORES = ("    so[static_cast<size_t>(i) * n + j] = sim;\n"
              "    po[static_cast<size_t>(i) * n + j] = present ? 1 : 0;\n")
_IG_TAB = ("                   : dn[ii] < tabn ? tab[dn[ii]]\n"
           "                                   : __fsub_rn(")

_PQ_LB = "__launch_bounds__(rp::threads(kTiles), 3 - kTiles)\n    masked_pair_sums_kernel"
_PQ_RING = "constexpr int kRaw = 4; "
_PQ_VALUES = "  const bool values = impop::named_or(rp::kSyncId + 1 + wg, 128, other);\n"
_PQ_MMA = "    chunk_products(acc, cur, dec + (c & 1) * kDecHalf, mask_b, values);\n"
_PQ_DECODE = "    for (int it = tid; it < kColTile * (rp::kKc / 8); it += kCons) {\n"
_PQ_SPLIT = "      split_x(xv, next);\n"
_PQ_LOAD = "      if (k + 2 < nch) load_x(x, ld, rows, n, (k + 2) * kKc, t, xv);\n"
_PQ_STORE = "    if (row < rows && j < N) y["

SUMS_VARIANTS = {
    "base": [],
    "occ2": [(_PQ_LB, _PQ_LB.replace("3 - kTiles)", "2)"))],
    "ring8": [(_PQ_RING, _PQ_RING.replace("4", "8"))],
    "ring2": [(_PQ_RING, _PQ_RING.replace("4", "2"))],
    "allpieces": [(_PQ_VALUES, "  const bool values = other || true;\n")],
    "nomma": [(_PQ_MMA, "")],
    "nodecode": [(_PQ_DECODE, _PQ_DECODE.replace("it < kColTile", "it < 0 * kColTile"))],
    "nox": [(_PQ_SPLIT, ""), (_PQ_LOAD, "")],
    "nostore": [(_PQ_STORE, "    if (row < 0 && j < N) y[")],
}
GROUP_VARIANTS = {
    "base": [],
    "occ3": [(_IG_LB, _IG_LB.replace("(kThreads)", "(kThreads, 3)"))],
    "orwords": [(_IG_FORM, "  const bool bits_form = false;\n")],
    "smemrows": [(_IG_COUNTS, _IG_SMEMROWS)],
    "notab": [(_IG_TAB, "                   : __fsub_rn(")],
    "nomirror": [(_IG_MIRROR, "  for (int jj = 32; jj < 32; ++jj) {\n")],
    "nostores": [(_IG_MIRROR, "  for (int jj = 32; jj < 32; ++jj) {\n"),
                 (_IG_STORES, "")],
}
_CHECKED = ("base", "occ2", "ring8", "ring2", "allpieces", "occ3", "orwords",
            "smemrows", "notab")


def _bind(libs: dict) -> dict:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for lib in libs.values():
        if hasattr(lib, "impop_masked_pair_sums"):
            lib.impop_masked_pair_sums.argtypes = [p] * 4 + [i] * 5 + [p] * 4
            lib.impop_masked_pair_sums.restype = i
        if hasattr(lib, "impop_identity_group"):
            lib.impop_identity_group.argtypes = ([p] * 5 + [f] + [i] * 4
                                                 + [p] * 8)
            lib.impop_identity_group.restype = i
        lib.impop_error_string.argtypes = [i]
        lib.impop_error_string.restype = ctypes.c_char_p
    return libs


def _times(libs: dict, cases: dict) -> list:
    """'name case ms' for every variant and case; checked variants must
    give the base's results."""
    import torch

    import impop_tpu_torch.ops._build as build_mod
    from impop_tpu_torch.bench import graph_ms

    saved = build_mod.load_library
    row, want = [], {}
    try:
        for name, lib in libs.items():
            build_mod.load_library = lambda lib=lib: lib
            for tag, fn in cases.items():
                got = fn()
                torch.cuda.synchronize()
                if name == "base":
                    want[tag] = got
                elif name in _CHECKED and not all(
                        torch.equal(a, b) for a, b in zip(got, want[tag])):
                    raise RuntimeError(f"{name} {tag}: results differ from "
                                       "the base")
                row.append(f"{name} {tag} {graph_ms(fn, 20):.4f}")
    finally:
        build_mod.load_library = saved
    return row


def main() -> int:
    import numpy as np
    import torch

    import impop_tpu_torch.ops._build as build_mod
    from impop_tpu_torch.bench import build_variants, inputs
    from impop_tpu_torch.ops.idgroup import identity_group
    from impop_tpu_torch.ops.pairdiff import pairwise_identity
    from impop_tpu_torch.ops.panelquad import masked_pair_sums
    from impop_tpu_torch.stats.panelstats import panel_mask_stack

    if not torch.cuda.is_available():
        print("sums_group_variants: needs a CUDA device", file=sys.stderr)
        return 2
    from impop_tpu_torch.bench.roofline import nvidia_smi_line

    smi = nvidia_smi_line()
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    sums = {}
    for w, r, tag in ((64, 35, "35+35x64"), (128, 2, "2+2x128")):
        g, m, sm, _, ln = inputs.to_dev(dev, *inputs.hprc_batch(rng, w))
        sim, pres = pairwise_identity(g, m, sm, ln)
        wd = torch.rand((w, r, inputs.CAP_N), device=dev)
        wp = (torch.rand((w, r, inputs.CAP_N), device=dev) < 0.3).float()
        if r == 2:
            wd = wp
        sums[tag] = lambda xs=(sim, pres, wd, wp): masked_pair_sums(*xs)
    geno, member, smask, panels, lengths = inputs.hprc_batch(
        rng, inputs.BATCH)
    p = panels.shape[1]
    pairs = [(i, j) for i in range(p) for j in range(i + 1, p)]
    g, m, sm, pn, ln = inputs.to_dev(dev, geno, member, smask, panels,
                                     lengths)
    stack = panel_mask_stack(pn, m, tuple(a for a, _ in pairs),
                             tuple(b for _, b in pairs), True)[0]
    group = {f"R={stack.shape[-2]}x{inputs.BATCH}": lambda: identity_group(
        g, m, sm, stack, inputs.THRESHOLD, ln)}
    os.makedirs(build_mod._BUILD, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_mod._BUILD) as work:
        pq_dir, ig_dir = os.path.join(work, "pq"), os.path.join(work, "ig")
        os.makedirs(pq_dir)
        os.makedirs(ig_dir)
        sums_libs = _bind(build_variants("panelquad.cu", SUMS_VARIANTS,
                                         pq_dir, extra=("windowstat.cu",)))
        group_libs = _bind(build_variants("idgroup.cu", GROUP_VARIANTS,
                                          ig_dir, extra=("windowstat.cu",)))
        row = _times(sums_libs, sums) + _times(group_libs, group)
    print(f"sums_group_variants on {smi}: device ms (CUDA graph replays, "
          "median of 20): " + ", ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
