"""The device step against the float64 oracle, on the card.

    python -m impop_tpu_torch.bench.check_device_oracle [--device cuda|cpu]
        [--windows W]

Runs ``fused_window_stats`` over HPRC-shaped windows (``inputs.hprc_batch``,
seed 99) twice, with ``return_matrices=False`` (the window kernel) and
``return_matrices=True`` (``identity_group`` and the masked sums), and
compares every π, direct Fst, grouped Fst and S value with
``bench/oracle.py`` computed in float64 on the same float32 similarity
values: S exact, π rtol 1e-4, Fst atol 2e-3.  Exits non-zero on any miss.
The twin of the repository's ``tools/check_device_oracle.py``.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from impop_tpu_torch.bench import inputs, oracle
from impop_tpu_torch.bench.main import PAIR_A, PAIR_B, PAIRS

PI_RTOL = 1e-4
FST_ATOL = 2e-3


def device_rows(dev, batch, return_matrices: bool):
    """(π [W, P+Q], Fst [W, Q], grouped Fst [W, Q], S [W]) as numpy."""
    from impop_tpu_torch.stats.panelstats import fused_window_stats

    g, m, sm, p, ln = inputs.to_dev(dev, *batch)
    _sim, _pres, s_count, res = fused_window_stats(
        g, m, sm, ln, p, PAIR_A, PAIR_B, inputs.THRESHOLD,
        pairs_disjoint=True, return_matrices=return_matrices)
    return tuple(x.cpu().numpy() for x in (res.pi, res.hudson.fst,
                                           res.hudson_grouped.fst, s_count))


def misses(batch, rows) -> tuple[list, float]:
    """(the values outside their tolerance, the largest error) of ``rows``
    against the oracle, window by window."""
    geno, member, smask, panels, lengths = batch
    pi_d, fst_d, fstg_d, s_d = rows
    names_of = list(inputs.PANEL_SIZES)
    t = inputs.THRESHOLD
    bad, max_err = [], 0.0
    for wi in range(geno.shape[0]):
        g = geno[wi][member[wi]][:, smask[wi]]
        n = g.shape[0]
        names = [f"h{i:04d}" for i in range(n)]
        length = np.float32(lengths[wi])
        diff = (g[:, None, :] != g[None, :, :]).sum(-1)
        # the device's float32 similarities, so the strict > threshold
        # decisions are the same (1 - k / L is not exact in binary)
        simm = (np.float32(1.0) - diff.astype(np.float32) / length).astype(
            np.float32)
        sd = {(names[i], names[j]): float(simm[i, j])
              for i in range(n) for j in range(i + 1, n)}
        s_np = int((g.max(0) != g.min(0)).sum())
        if int(s_d[wi]) != s_np:
            bad.append((wi, "S", s_np, float(s_d[wi])))
        members = [[names[i] for i in range(n) if panels[wi, k][member[wi]][i]]
                   for k in range(len(names_of))]
        for k, sub in enumerate(members):
            keep = set(sub)
            pval, _ = oracle.pica2_pi(
                {key: v for key, v in sd.items()
                 if key[0] in keep and key[1] in keep}, sub, t)
            e = abs(pval - float(pi_d[wi, k])) / max(abs(pval), 1e-12)
            max_err = max(max_err, e)
            if e >= PI_RTOL:
                bad.append((wi, f"pi {names_of[k]}", pval, float(pi_d[wi, k])))
        for q, (a, b) in enumerate(PAIRS):
            pa = members[names_of.index(a)]
            pb = members[names_of.index(b)]
            for tag, want, got in (
                    ("Fst", oracle.hudson_fst_direct(sd, pa, pb)["fst"],
                     fst_d[wi, q]),
                    ("FstG", oracle.hudson_fst_grouped(sd, pa, pb, t)["fst"],
                     fstg_d[wi, q])):
                e = abs(want - float(got))
                max_err = max(max_err, e)
                if not e < FST_ATOL:
                    bad.append((wi, f"{tag} {a}/{b}", want, float(got)))
    return bad, max_err


def main(argv=None) -> int:
    from impop_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser(
        prog="python -m impop_tpu_torch.bench.check_device_oracle")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--windows", type=int, default=8)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    batch = inputs.hprc_batch(np.random.default_rng(99), args.windows)
    failed = False
    for return_matrices in (False, True):
        bad, max_err = misses(batch, device_rows(dev, batch, return_matrices))
        what = ("identity_group + masked sums" if return_matrices
                else "window kernel")
        route = f"return_matrices={return_matrices} ({what})"
        if bad:
            failed = True
            print(f"check_device_oracle {route}: {len(bad)} misses, first "
                  f"{bad[:5]}", flush=True)
        else:
            print(f"check_device_oracle {route} on {dev}: OK over "
                  f"{args.windows} windows x {len(inputs.PANEL_SIZES)} panels"
                  f" x {len(PAIRS)} pairs; max err {max_err:.2e}",
                  flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
