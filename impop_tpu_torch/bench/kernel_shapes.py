"""The window kernel and the masked sums at every shape their card tests
drive, timed on the card.

    python impop_tpu_torch/bench/kernel_shapes.py

Imports the ``impop_tpu_torch`` of the working directory (so one copy of
the script times another tree's kernels: run it from that tree's root)
and uses only the wrappers' public signatures.  Prints, with the card's
name and power limit, the device time of one call at each shape (CUDA
graph replays, median of 20) and, for the window kernel, the device time
of its phase C (``window_products_kernel``, torch.profiler, median of 5):

  window_stats      [512, 128] x 320, 5 disjoint panels (HPRC); [512, 4096]
                    x 8; [96, 128] x 64 and [160, 128] x 64 with 4
                    overlapping panels (ragged column tiles); [1152, 128] x
                    8 (link bits in device memory); [256, 128] x 16 with 10
                    overlapping panels (X columns in device memory)
  masked_pair_sums  [512, 512] x 64 with 35 + 35 rows (fp32 Wd, 0/1 Wp);
                    x 128 with 2 + 2 0/1 rows (the drivers); [4096, 4096]
                    x 2 with 128, 256 and 150 fp32 rows against 140 0/1 rows
"""
from __future__ import annotations

import os
import statistics
import sys


def _window_cases(rng):
    import numpy as np

    from impop_tpu_torch.bench import inputs

    def overlapping(w, cap_n, n_hap, p):
        geno, member, smask, _, lengths = inputs.hprc_batch(
            rng, w, cap_n=cap_n, n_hap=n_hap)
        return geno, member, smask, rng.random((w, p, cap_n)) < 0.4, lengths

    long = inputs.hprc_batch(rng, 8, cap_s=4096)
    long[0][:, :inputs.N_HAP, :] = np.where(
        rng.random((8, inputs.N_HAP, 4096)) < 0.02, 1, 0).astype(np.int8)
    long[2][:] = True
    long[4][:] = 200_000.0
    return [
        ("[512,128]x320 HPRC", inputs.hprc_batch(rng, inputs.BATCH), True),
        ("[512,4096]x8", long, True),
        ("[96,128]x64 4 panels", overlapping(64, 96, 90, 4), False),
        ("[160,128]x64 4 panels", overlapping(64, 160, 150, 4), False),
        ("[1152,128]x8", inputs.hprc_batch(rng, 8, cap_n=1152, n_hap=1100),
         True),
        ("[256,128]x16 10 panels", overlapping(16, 256, 230, 10), False),
    ]


def _sums_cases(dev, rng):
    import torch

    from impop_tpu_torch.bench import inputs
    from impop_tpu_torch.ops.pairdiff import pairwise_identity

    cases = []
    for w, r, tag in ((64, 35, "[512,512]x64 35 + 35"),
                      (128, 2, "[512,512]x128 2 + 2")):
        g, m, sm, _, ln = inputs.to_dev(dev, *inputs.hprc_batch(rng, w))
        sim, pres = pairwise_identity(g, m, sm, ln)
        wp = (torch.rand((w, r, inputs.CAP_N), device=dev) < 0.3).float()
        wd = wp if r == 2 else torch.rand((w, r, inputs.CAP_N), device=dev)
        cases.append((tag, (sim, pres, wd, wp)))
    n = 4096
    sim = torch.rand((2, n, n), device=dev)
    pres = torch.rand((2, n, n), device=dev) < 0.9
    wp = (torch.rand((2, 140, n), device=dev) < 0.3).float()
    for rd in (128, 256, 150):
        wd = torch.rand((2, rd, n), device=dev)
        cases.append((f"[{n},{n}]x2 {rd} + 140", (sim, pres, wd, wp)))
    return cases


def _profiled_ms(fn, name, reps=5):
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        times.append(sum(getattr(e, "self_device_time_total", 0)
                         for e in prof.key_averages() if name in e.key) / 1e3)
    return statistics.median(times)


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_shapes: needs a CUDA device", file=sys.stderr)
        return 2
    from impop_tpu_torch.bench import graph_ms, inputs
    from impop_tpu_torch.bench.roofline import nvidia_smi_line
    from impop_tpu_torch.ops.panelquad import masked_pair_sums
    from impop_tpu_torch.ops.windowstat import window_stats
    from impop_tpu_torch.stats.panelstats import panel_mask_stack

    dev = torch.device("cuda")
    rng = np.random.default_rng(23)
    rows = []
    for tag, batch, disjoint in _window_cases(rng):
        geno, member, smask, panels, lengths = batch
        p = panels.shape[1]
        pairs = [(i, j) for i in range(p) for j in range(i + 1, p)]
        pa, pb = tuple(a for a, _ in pairs), tuple(b for _, b in pairs)
        g, m, sm, pn, ln = inputs.to_dev(dev, geno, member, smask, panels,
                                         lengths)
        stack, ma, mb = panel_mask_stack(pn, m, pa, pb, disjoint)
        args = (g, m, sm, stack, ma, mb, inputs.THRESHOLD, ln, pa, pb,
                disjoint)
        call = graph_ms(lambda: window_stats(*args), 20)
        phase_c = _profiled_ms(lambda: window_stats(*args),
                               "window_products_kernel")
        rows.append(f"window_stats {tag}: {call:.4f} ms a call, phase C "
                    f"{phase_c:.4f}")
    for tag, xs in _sums_cases(dev, rng):
        rows.append(f"masked_pair_sums {tag}: "
                    f"{graph_ms(lambda: masked_pair_sums(*xs), 20):.4f} ms a call")
    print(f"kernel_shapes ({os.getcwd()}) on {nvidia_smi_line()}; device ms "
          "(CUDA graph replays, median of 20; phase C by torch.profiler, "
          "median of 5):", flush=True)
    for row in rows:
        print("  " + row, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
