"""Site-sharded statistics for long windows (counterpart of
:mod:`impop_tpu.parallel.longwindow`).

The site axis of an allele tile is split over the mesh ``site`` axis:
each device computes the pairwise difference and comparison counts and S
over its site slice, and the partials are summed over ``site`` on the
data shard's first device, so one window can span the memory of several
devices.  Then, per window, the identity epilogue, pica2-grouped π (the
seed-peel and masked-sums kernels on CUDA tensors) and Tajima's D.
"""
from __future__ import annotations

import torch

from impop_tpu_torch.device import on_device
from impop_tpu_torch.parallel.mesh import (Mesh, gather_windows, reduce_sum,
                                           split_sites, split_windows)
from impop_tpu_torch.stats.allele import (pairwise_diff_biallelic,
                                          segregating_sites)
from impop_tpu_torch.stats.pi import pi_grouped_panels
from impop_tpu_torch.stats.tajima import tajimas_d

__all__ = ["site_sharded_window_stats"]


def _finish(diff, comp, member, length, s_count, threshold):
    """Per-site π and D of windows [w] from their summed counts, with the
    JAX package's epilogue: present needs a compared site and two members
    (the diagonal too), sim is 1 on the member diagonal."""
    present = (comp > 0) & member[:, :, None] & member[:, None, :]
    denom = torch.clamp(length, min=1.0)[:, None, None]
    sim = torch.where(present, 1.0 - diff / denom, 0.0)
    eye = torch.eye(member.shape[-1], dtype=torch.bool, device=diff.device)
    sim = torch.where(eye & member[:, :, None], 1.0, sim)
    # pi_grouped with the member mask as the one panel: the grouping and
    # the quadratic form run in the seed-peel and masked-sums kernels
    res = pi_grouped_panels(sim, present, member, member[:, None, :],
                            threshold)
    pi_site = res.pi[:, 0] / torch.clamp(length, min=1.0)
    d = tajimas_d(res.n[:, 0], s_count.to(torch.float32), pi_site)
    return pi_site, d


def site_sharded_window_stats(mesh: Mesh, max_n: int):
    """A [W, N, S] -> per-window (π per site, S, D) function with W split
    over ``data`` and S over ``site``.

    Returns ``fn(geno, member, site_mask, lengths, threshold)`` (tensors or
    numpy arrays: geno [W, N, S] int8 0/1/-1, member [W, N], site_mask
    [W, S], lengths [W]); its outputs are [W] tensors on the mesh's first
    device.  Per (data, site) device: the difference and comparison
    counts (fp32 products, exact below 2^24) and S of its site slice;
    summed over ``site``; then per data shard the epilogue above.
    ``max_n`` is the JAX signature's and unused there too.
    """
    del max_n

    def fn(geno, member, site_mask, lengths, threshold):
        n_windows = geno.shape[0]
        g = split_sites(geno, mesh, 2)
        sm = split_sites(site_mask, mesh, 1)
        mem = [[rows.to(d) for d in grid_row] for rows, grid_row
               in zip(split_windows(member, mesh), mesh.grid)]
        lens = split_windows(torch.as_tensor(lengths, dtype=torch.float32),
                             mesh)
        partials = []
        for i, row in enumerate(mesh.grid):
            parts = []
            for j, dev in enumerate(row):
                with on_device(dev):
                    diff, comp = pairwise_diff_biallelic(g[i][j], mem[i][j],
                                                         sm[i][j])
                    s_local = segregating_sites(g[i][j], mem[i][j],
                                                sm[i][j])
                parts.append((diff, comp, s_local))
            partials.append(parts)
        pis, ss, ds = [], [], []
        for i, row in enumerate(mesh.grid):
            with on_device(row[0]):
                diff, comp, s_count = (
                    reduce_sum([p[k] for p in partials[i]])
                    for k in range(3))
                pi_site, d = _finish(diff, comp, mem[i][0], lens[i],
                                     s_count, threshold)
            pis.append(pi_site)
            ss.append(s_count)
            ds.append(d)
        return (gather_windows(pis, n_windows),
                gather_windows(ss, n_windows),
                gather_windows(ds, n_windows))

    return fn
