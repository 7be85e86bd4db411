"""Where the time of the window kernel's phase C goes, on the card.

    python -m impop_tpu_torch.bench.window_breakdown

Builds variants of ``csrc/windowstat.cu`` (and of the ``csrc/rowprod.cuh``
product it includes) with one part of ``window_products_kernel`` taken
out (text substitutions; the results of a variant are wrong by design and
are not checked), runs the whole window program of each on [512, 128] x
320 HPRC-shaped windows (5 panels, 10 disjoint pairs: ``bench.inputs``,
as in ``chip_smoke.py`` phase 2a) and prints the device time of
``window_products_kernel`` (torch.profiler, median of 5 calls).  A part's
cost is the base time minus the variant's; parts that overlap cost less
than their sum.

  base      the kernel as built for the port
  novalue   no wgmma products of the value rows
  nostage   no decode of the diff tiles into bf16 pieces
  nox       no loads and splits of the X rows after the first chunk
  nomask    no 0/1 rows (their b1 mma counts and row-dots)
  nodots    no row-dots
"""
from __future__ import annotations

import ctypes
import os
import statistics
import sys
import tempfile

_PRODUCTS = "    chunk_products(acc, cur, dec + (c & 1) * kDecHalf, mask_b, values);\n"
_DECODE = "    for (int it = tid; it < kColTile * (rp::kKc / 8); it += kCons) {\n"
_SPLIT = "      split_x(xv, next);\n"
_LOAD = "      if (k + 2 < nch) load_x(x, ld, rows, n, (k + 2) * kKc, t, xv);\n"
_MASK = "  for (int g0 = p.rd; g0 < xrows; g0 += kRowChunk) {\n"
_DOTS = "  for (int t = tid; t < p.t; t += n_threads) {\n"

VARIANTS = {
    "base": [],
    "novalue": [(_PRODUCTS, "")],
    "nostage": [(_DECODE, _DECODE.replace("it < kColTile", "it < 0 * kColTile"))],
    "nox": [(_SPLIT, ""), (_LOAD, "")],
    "nomask": [(_MASK, _MASK.replace("g0 = p.rd;", "g0 = xrows;"))],
    "nodots": [(_DOTS, _DOTS.replace("t = tid;", "t = p.t;"))],
}


def build(work: str) -> dict:
    from impop_tpu_torch.bench import build_variants

    libs = build_variants("windowstat.cu", VARIANTS, work)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for lib in libs.values():
        lib.impop_window_stats.argtypes = [p] * 8 + [f] + [i] * 10 + [p] * 10
        lib.impop_window_stats.restype = i
        lib.impop_error_string.argtypes = [i]
        lib.impop_error_string.restype = ctypes.c_char_p
    return libs


def products_ms(fn, reps: int = 5) -> float:
    """Median device ms of window_products_kernel over reps calls of fn."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if "window_products_kernel" in e.key:
                us = getattr(e, "self_device_time_total", None)
                if us is None:
                    us = e.self_cuda_time_total
                times.append(us / 1e3)
    return statistics.median(times)


def main() -> int:
    import numpy as np
    import torch

    import impop_tpu_torch.ops._build as build_mod
    from impop_tpu_torch.bench import inputs
    from impop_tpu_torch.ops.windowstat import window_stats
    from impop_tpu_torch.stats.panelstats import panel_mask_stack

    if not torch.cuda.is_available():
        print("window_breakdown: needs a CUDA device", file=sys.stderr)
        return 2
    from impop_tpu_torch.bench.roofline import nvidia_smi_line

    smi = nvidia_smi_line()
    dev = torch.device("cuda")
    geno, member, smask, panels, lengths = inputs.hprc_batch(
        np.random.default_rng(7), inputs.BATCH)
    p = panels.shape[1]
    pairs = [(i, j) for i in range(p) for j in range(i + 1, p)]
    pa, pb = tuple(a for a, _ in pairs), tuple(b for _, b in pairs)
    g, m, sm, pn, ln = inputs.to_dev(dev, geno, member, smask, panels,
                                     lengths)
    stack, ma, mb = panel_mask_stack(pn, m, pa, pb, True)
    args = (g, m, sm, stack, ma, mb, inputs.THRESHOLD, ln, pa, pb, True)
    os.makedirs(build_mod._BUILD, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_mod._BUILD) as work:
        libs = build(work)
        row = []
        saved = build_mod.load_library
        try:
            for name, lib in libs.items():
                build_mod.load_library = lambda lib=lib: lib
                row.append(f"{name} {products_ms(lambda: window_stats(*args)):.4f}")
        finally:
            build_mod.load_library = saved
    print(f"window_breakdown on {smi}: window_products_kernel device ms "
          f"(torch.profiler, median of 5) at [{inputs.CAP_N},"
          f"{inputs.CAP_S}]x{inputs.BATCH}: " + ", ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
