"""The window kernel against the other routes of ``fused_window_stats``.

    python -m impop_tpu_torch.bench.windowstat [--device cuda|cpu]
        [--windows 2240] [--sweep-windows 64]
        [--sites 128 512 2048 4096 8192 16384] [--iters 16]

1. On bench.py's batch (``inputs.hprc_batch`` seed 42, [512, 128]) the rows
   of ``return_matrices=False`` (the window kernel) against those of
   ``return_matrices=True`` (``identity_group``, then ``fused_panel_stats``
   and the masked sums): integer columns exact, π and D rtol 1e-5, Fst
   atol 2e-3; then both timed (back-to-back calls ended by a fetch).
2. At each S of ``--sites`` (``inputs.long_batch``: long windows, every
   site but the last 37 active, 1% missing calls), ``--sweep-windows``
   windows of 512 haplotypes: the window kernel against the composed
   route the scan takes past the kernel's caps
   (``stats.panelstats.composed_window_stats``: the unit identity kernel,
   S, ``fused_panel_stats``), the rows checked as in 1 and both timed.

Exits non-zero when two routes disagree.  The twin of the repository's
``tools/bench_windowstat.py``.
"""
from __future__ import annotations

import argparse
import sys

INT_COLS = ("n", "num_groups", "pairs_used", "s", "seed_risk")


def rows(s_count, res, p_count, lengths) -> dict:
    """The compared columns of one route's result."""
    import torch

    from impop_tpu_torch.stats.tajima import tajimas_d

    pi_panel = res.pi[..., :p_count]
    return {
        "pi": res.pi,
        "d": tajimas_d(res.n[..., :p_count], s_count[..., None],
                       pi_panel / lengths[..., None]),
        "fst": res.hudson.fst, "fstg": res.hudson_grouped.fst,
        "n": res.n, "num_groups": res.num_groups,
        "pairs_used": res.pairs_used, "s": s_count,
        "seed_risk": res.seed_risk.to(torch.int32),
    }


def disagreements(got: dict, want: dict) -> list:
    """The columns of ``got`` outside their tolerance of ``want``."""
    import torch

    bad = []
    for key, a in got.items():
        b = want[key]
        if key in INT_COLS:
            ok = torch.equal(a, b)
        elif key.startswith("fst"):
            ok = torch.allclose(a, b, rtol=0.0, atol=2e-3, equal_nan=True)
        else:
            ok = torch.allclose(a, b, rtol=1e-5, atol=1e-7, equal_nan=True)
        if not ok:
            bad.append(key)
    return bad


def main(argv=None) -> int:
    import numpy as np

    from impop_tpu_torch.bench import inputs
    from impop_tpu_torch.bench.main import PAIR_A, PAIR_B, timed
    from impop_tpu_torch.device import resolve_device
    from impop_tpu_torch.stats.panelstats import (composed_window_stats,
                                                  fused_window_stats)

    ap = argparse.ArgumentParser(prog="python -m impop_tpu_torch.bench."
                                 "windowstat")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--windows", type=int, default=2240)
    ap.add_argument("--sweep-windows", type=int, default=64)
    ap.add_argument("--sites", type=int, nargs="+",
                    default=[128, 512, 2048, 4096, 8192, 16384])
    ap.add_argument("--iters", type=int, default=16)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    where = "cpu, plain versions"
    if dev.type == "cuda":
        from impop_tpu_torch.bench.roofline import nvidia_smi_line

        where = nvidia_smi_line()
    thr = inputs.THRESHOLD
    p_count = len(inputs.PANEL_SIZES)

    def route(name):
        def step(g, m, sm, p, ln):
            if name == "composed":
                return composed_window_stats(g, m, sm, ln, p, PAIR_A, PAIR_B,
                                             thr, pairs_disjoint=True)
            _, _, s, res = fused_window_stats(
                g, m, sm, ln, p, PAIR_A, PAIR_B, thr, pairs_disjoint=True,
                return_matrices=name == "matrices")
            return s, res
        return step

    def fetch_res(step):
        return lambda *a: step(*a)[1].pi

    def compare_and_time(batch, names, tag):
        outs = {k: route(k)(*batch) for k in names}
        want = rows(*outs[names[0]], p_count, batch[4])
        got = rows(*outs[names[1]], p_count, batch[4])
        bad = disagreements(got, want)
        if bad:
            print(f"windowstat {tag}: {names[1]} differs from {names[0]} in "
                  f"{bad}", flush=True)
            return False
        w = batch[0].shape[0]
        times = {}
        for k in names:
            dt, _ = timed(fetch_res(route(k)), batch, args.iters)
            times[k] = dt / (args.iters * w) * 1e6
        print(f"windowstat {tag}: rows agree; " + ", ".join(
            f"{k} {us:.3f} us/window" for k, us in times.items())
            + f" [{where}]", flush=True)
        return True

    rng = np.random.default_rng(42)
    batch = inputs.to_dev(dev, *inputs.hprc_batch(rng, args.windows))
    ok = compare_and_time(batch, ("matrices", "kernel"),
                          f"[{inputs.CAP_N},{inputs.CAP_S}]x{args.windows}")
    panels = inputs.hprc_batch(rng, 1)[3][0]
    for s in args.sites:
        w = args.sweep_windows
        geno, member, smask, lengths = inputs.long_batch(
            np.random.default_rng(s), w, cap_s=s)
        pn = np.broadcast_to(panels, (w,) + panels.shape).copy()
        batch = inputs.to_dev(dev, geno, member, smask, pn, lengths)
        ok &= compare_and_time(batch, ("composed", "kernel"),
                               f"S = {s}, [{inputs.CAP_N},{s}]x{w}")
        del batch
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
