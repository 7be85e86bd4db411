"""The device step of the benchmark cut into nested prefixes.

    python -m impop_tpu_torch.bench.panelstep [--device cuda|cpu]
        [--windows 320] [--iters 16]

On ``--windows`` HPRC-shaped windows ([512, 128], 5 panels, 10 disjoint
pairs, ``inputs.hprc_batch`` seed 42) it times, as bench.py times its
step (back-to-back calls ended by a fetch to the host):

  1 identity + S          ``identity_from_alleles`` (``unit_gram_kernel``)
                          and ``segregating_sites``
  2 + seed peel           the greedy seeds and gid of the 15 panel and
                          union masks (``seed_link_kernel``,
                          ``seed_peel_kernel``)
  3 + fused_panel_stats   grouping, weights and ``masked_pair_sums``
  4 identity_group + tail ``identity_group`` (identity, grouping and S in
                          one kernel) then ``fused_panel_stats`` on its
                          grouping (``return_matrices=True``)
  5 window kernel         ``fused_window_stats(return_matrices=False)``
  6 full device step      bench's step (adds Tajima's D and 3-π Fst)

and beside each the [N, N] bytes per window it implies (sim f32 and
present 1 byte a pair, each written or read once: identity writes 5,
the seed peel reads 5, the masked sums 5, ``seed_risk`` 1), with the time
those bytes take at the H100's 3.35 TB/s.  The twin of the repository's
``tools/bench_panelstep.py``.
"""
from __future__ import annotations

import argparse
import sys


def prefixes(pair_a, pair_b, threshold):
    """[(tag, step, [N, N] bytes per pair)] of the nested prefixes; each
    step maps (geno, member, smask, panels, lengths) to one tensor."""
    from impop_tpu_torch.bench.main import device_step
    from impop_tpu_torch.ops.idgroup import identity_group
    from impop_tpu_torch.ops.seedpeel import seed_peel
    from impop_tpu_torch.stats.allele import (identity_from_alleles,
                                              segregating_sites)
    from impop_tpu_torch.stats.panelstats import (fused_panel_stats,
                                                  fused_window_stats,
                                                  panel_mask_stack)

    def stats_sum(res):
        return (res.pi.sum() + res.hudson.fst.sum()
                + res.hudson_grouped.fst.sum())

    def ident(g, m, sm, p, ln):
        sim, _present = identity_from_alleles(g, m, sm, ln)
        return sim.sum() + segregating_sites(g, m, sm).sum()

    def peel(g, m, sm, p, ln):
        sim, present = identity_from_alleles(g, m, sm, ln)
        masks, _, _ = panel_mask_stack(p, m, pair_a, pair_b, True)
        seeds, gid = seed_peel(sim, present, m, masks, threshold)
        return (sim.sum() + seeds.sum() + gid.sum()
                + segregating_sites(g, m, sm).sum())

    def fused(g, m, sm, p, ln):
        sim, present = identity_from_alleles(g, m, sm, ln)
        res = fused_panel_stats(sim, present, m, p, pair_a, pair_b,
                                threshold, pairs_disjoint=True)
        return stats_sum(res) + segregating_sites(g, m, sm).sum()

    def idgroup(g, m, sm, p, ln):
        masks, _, _ = panel_mask_stack(p, m, pair_a, pair_b, True)
        sim, present, gid, s = identity_group(g, m, sm, masks, threshold, ln)
        res = fused_panel_stats(sim, present, m, p, pair_a, pair_b,
                                threshold, pairs_disjoint=True, gid=gid)
        return stats_sum(res) + s.sum()

    def window(g, m, sm, p, ln):
        _, _, s, res = fused_window_stats(g, m, sm, ln, p, pair_a, pair_b,
                                          threshold, pairs_disjoint=True,
                                          return_matrices=False)
        return stats_sum(res) + s.sum()

    return [("1 identity + S", ident, 5),
            ("2 + seed peel", peel, 10),
            ("3 + fused_panel_stats", fused, 16),
            ("4 identity_group + tail", idgroup, 11),
            ("5 window kernel", window, 0),
            ("6 full device step", device_step, 0)]


def main(argv=None) -> int:
    import numpy as np

    from impop_tpu_torch.bench import inputs
    from impop_tpu_torch.bench.main import PAIR_A, PAIR_B, timed
    from impop_tpu_torch.bench.roofline import H100_BYTES_PER_S
    from impop_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser(prog="python -m impop_tpu_torch.bench."
                                 "panelstep")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--windows", type=int, default=inputs.BATCH)
    ap.add_argument("--iters", type=int, default=16)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    w = args.windows
    batch = inputs.to_dev(dev, *inputs.hprc_batch(np.random.default_rng(42),
                                                  w))
    where = "cpu, plain versions"
    if dev.type == "cuda":
        from impop_tpu_torch.bench.roofline import nvidia_smi_line

        where = nvidia_smi_line()
    nn = inputs.CAP_N * inputs.CAP_N
    print(f"panelstep [{inputs.CAP_N},{inputs.CAP_S}]x{w} on {where}; "
          f"{args.iters} calls a prefix, ended by a fetch", flush=True)
    for tag, step, per_pair in prefixes(PAIR_A, PAIR_B, inputs.THRESHOLD):
        dt, _ = timed(step, batch, args.iters)
        us = dt / (args.iters * w) * 1e6
        mb = per_pair * nn / 1e6
        floor_us = per_pair * nn / H100_BYTES_PER_S * 1e6
        share = (f", {100 * floor_us / us:.1f}% of it"
                 if dev.type == "cuda" and per_pair else "")
        print(f"{tag:26s} {us:9.3f} us/window ({w * args.iters / dt:10.0f}"
              f" win/s); [N,N] bytes {mb:.2f} MB/window -> {floor_us:.3f}"
              f" us at 3.35 TB/s{share}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
