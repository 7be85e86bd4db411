"""The haplotype pair space split over devices by row blocks (counterpart
of :mod:`impop_tpu.parallel.pairspace`).

Past a few thousand haplotypes one device neither holds nor wants a
window's full [N, N] identity matrix.  Each device of a mesh axis takes an
[N/D, S] block of rows against the whole [N, S] tile (the small operand,
replicated), forms only its [N/D, N] block of difference and comparison
counts, and reduces it at once into the masked sums every direct-method
statistic needs: π within each side, Dxy across, pair counts, and the
per-column min / max for S.  The partials are summed (min, max) on the
axis's first device; the [N, N] matrix exists on no device.

Scope: the direct-method statistics (h-fst.py) and S.  The grouped
estimators need the global grouping over [N, N] and stay on the
replicated path.  The products carry per-site values, so they are fp32
``torch.matmul`` with TF32 off (``device.resolve_device``), as the JAX
package runs them at ``Precision.HIGHEST`` outside any Pallas kernel.
"""
from __future__ import annotations

import torch

from impop_tpu_torch.device import on_device
from impop_tpu_torch.parallel.mesh import (Mesh, reduce_max, reduce_min,
                                           reduce_sum)

__all__ = ["pair_sharded_direct_stats"]

_BIG = torch.iinfo(torch.int32).max


def _block(geno_blk, geno_full, row0, member, site_mask, masks_a, masks_b,
           lengths):
    """One device's [W, 6, Q] masked sums and [W, S] per-column min / max
    for a batch of W windows."""
    f32 = torch.float32
    nb, n = geno_blk.shape[1], geno_full.shape[1]
    sm = site_mask[:, None, :]
    vb = ((geno_blk >= 0) & sm).to(f32)
    vf = ((geno_full >= 0) & sm).to(f32)
    xb = torch.clamp(geno_blk, min=0).to(f32) * vb
    xf = torch.clamp(geno_full, min=0).to(f32) * vf
    diff = xb @ (vf - xf).mT + (vb - xb) @ xf.mT           # [W, Nb, N]
    compared = vb @ vf.mT

    rows = torch.arange(row0, row0 + nb, device=geno_blk.device)
    cols = torch.arange(n, device=geno_blk.device)
    mrow = member[:, row0:row0 + nb]
    pair_ok = ((compared > 0) & (rows[:, None] != cols[None, :])
               & mrow[:, :, None] & member[:, None, :])
    div = torch.where(pair_ok,
                      diff / torch.clamp(lengths, min=1.0)[:, None, None],
                      0.0)
    okf = pair_ok.to(f32)

    # [W, Q, Nb] @ [W, Nb, N], then a row-dot against the column masks
    a_rows = (masks_a[:, :, row0:row0 + nb] & mrow[:, None, :]).to(f32)
    b_rows = (masks_b[:, :, row0:row0 + nb] & mrow[:, None, :]).to(f32)
    a_cols, b_cols = masks_a.to(f32), masks_b.to(f32)
    yd_a, yp_a = a_rows @ div, a_rows @ okf
    yd_b, yp_b = b_rows @ div, b_rows @ okf

    def rowdot(x, m):
        return (x * m).sum(dim=-1)

    part = torch.stack([
        rowdot(yd_a, a_cols), rowdot(yp_a, a_cols),     # within A (x2)
        rowdot(yd_b, b_cols), rowdot(yp_b, b_cols),     # within B (x2)
        rowdot(yd_a, b_cols), rowdot(yp_a, b_cols),     # cross (x1)
    ], dim=1)                                           # [W, 6, Q]

    g32 = geno_blk.to(torch.int32)
    valid = (geno_blk >= 0) & sm & mrow[:, :, None]
    cmin = torch.where(valid, g32, _BIG).amin(dim=1)
    cmax = torch.where(valid, g32, -1).amax(dim=1)
    return part, cmin, cmax


def pair_sharded_direct_stats(mesh: Mesh, axis: str = "data"):
    """A row-block split direct-stats function over the mesh axis ``axis``.

    Returns ``fn(geno, member, site_mask, masks_a, masks_b, length)`` with

      geno:      [N, S] int8 (N divisible by the axis size)
      member:    [N] bool;  site_mask: [S] bool
      masks_a:   [Q, N] bool, within/cross population masks (disjoint
                 from masks_b per pair, h-fst.py:181-185)
      masks_b:   [Q, N] bool
      length:    the window length (a float)

    (tensors or numpy arrays), returning (pi_a, pi_b, dxy, fst, s_count):
    the [Q] direct Hudson quantities of ``stats.fst.hudson_fst_direct_pairs``
    and the int32 S, on the axis's first device.

    A device batch of windows takes one call: every input with a leading
    window axis (geno [W, N, S], member [W, N], site_mask [W, S], masks
    [W, Q, N], length [W]) gives [W, Q] quantities and [W] S.  Each device
    then queues one block for the whole batch, so the host's enqueue is
    paid once a batch, not once a window.
    """
    devices = mesh.axis_devices(axis)

    def fn(geno, member, site_mask, masks_a, masks_b, length):
        geno, member, site_mask, masks_a, masks_b = (
            torch.as_tensor(x) for x in (geno, member, site_mask, masks_a,
                                         masks_b))
        one = geno.dim() == 2
        if one:
            geno, member, site_mask, masks_a, masks_b = (
                x[None] for x in (geno, member, site_mask, masks_a, masks_b))
        lengths = torch.as_tensor(length, dtype=torch.float32).reshape(-1)
        n = geno.shape[1]
        if n % len(devices):
            raise ValueError(f"pair shard: N={n} rows do not split over "
                             f"{len(devices)} devices")
        nb = n // len(devices)
        placed: dict = {}
        parts, mins, maxs = [], [], []
        for k, dev in enumerate(devices):
            if dev not in placed:   # the replicated operands, once a device
                placed[dev] = [x.to(dev) for x in (geno, member, site_mask,
                                                   masks_a, masks_b,
                                                   lengths)]
            g, m, sm, ma, mb, ln = placed[dev]
            with on_device(dev):
                part, cmin, cmax = _block(g[:, k * nb:(k + 1) * nb], g,
                                          k * nb, m, sm, ma, mb, ln)
            parts.append(part)
            mins.append(cmin)
            maxs.append(cmax)
        with on_device(devices[0]):
            part = reduce_sum(parts)
            cmin, cmax = reduce_min(mins), reduce_max(maxs)
            s_count = ((cmax > cmin) & (cmax >= 0)).sum(dim=-1,
                                                       dtype=torch.int32)

            def mean(total, count):
                return torch.where(count > 0,
                                   total / torch.clamp(count, min=1.0), 0.0)

            pi_a = mean(part[:, 0] * 0.5, part[:, 1] * 0.5)
            pi_b = mean(part[:, 2] * 0.5, part[:, 3] * 0.5)
            dxy = mean(part[:, 4], part[:, 5])
            pi_xy = 0.5 * (pi_a + pi_b)
            fst = torch.where(dxy > 0, (dxy - pi_xy)
                              / torch.where(dxy > 0, dxy, 1.0), 0.0)
        out = (pi_a, pi_b, dxy, fst, s_count)
        return tuple(x[0] for x in out) if one else out

    return fn
