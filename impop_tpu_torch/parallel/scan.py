"""Batched window statistics (port of :mod:`impop_tpu.parallel.scan`).

The JAX package vmaps one window (and one panel); here the window axis W
and the panel or pair axis are batch dimensions of one call: one grouping
call (the seed-peel kernel on CUDA tensors) and one masked-sums call (the
masked-sums kernel) for every window, panel and pair of a batch.

:func:`shard_batch` splits a batch over the ``data`` axis of a mesh and
:func:`batch_over` runs an estimator on every shard, each on its device,
and gathers the results in window order.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Sequence

import torch

from impop_tpu_torch.device import on_device
from impop_tpu_torch.parallel.mesh import Mesh, gather_windows, split_windows
from impop_tpu_torch.stats.allele import (AlleleWindowStats,
                                          allele_window_stats,
                                          identity_from_alleles,
                                          segregating_sites)
from impop_tpu_torch.stats.fst import (FstResult, fst_3pi,
                                       hudson_fst_direct_pairs,
                                       hudson_fst_grouped_pairs)
from impop_tpu_torch.stats.panelstats import take
from impop_tpu_torch.stats.pi import PiResult, pi_grouped, pi_grouped_panels
from impop_tpu_torch.stats.tajima import tajimas_d

__all__ = ["WindowBatch", "shard_batch", "batch_over", "batch_pi_panels",
           "HudsonBatchResult",
           "batch_hudson", "Fst3PiBatchResult", "batch_fst_3pi_panels",
           "batch_allele_stats", "TajdBatchResult",
           "batch_tajd_from_alleles"]

# bound on the [w, 2Q, N, N] temporaries of the grouped Hudson first-pair
# search per window chunk
_HUDSON_CHUNK_ELEMS = 1 << 27


class WindowBatch(NamedTuple):
    """W padded similarity tiles and their panel masks."""

    sim: torch.Tensor       # [W, N, N] f32
    present: torch.Tensor   # [W, N, N] bool
    member: torch.Tensor    # [W, N] bool
    panels: torch.Tensor    # [W, P, N] bool


def shard_batch(batch: WindowBatch, mesh: Mesh) -> List[WindowBatch]:
    """One WindowBatch per ``data`` shard of ``mesh``, each on its device:
    contiguous window chunks, padded with inert all-zero windows to a
    multiple of the axis size."""
    fields = [split_windows(a, mesh) for a in batch]
    return [WindowBatch(*parts) for parts in zip(*fields)]


def _gather(results: Sequence, n: int):
    """Per-shard results (tensors, or named tuples of them, nested) in
    window order on the first shard's device, cut to ``n`` windows."""
    first = results[0]
    if isinstance(first, torch.Tensor):
        return gather_windows(results, n)
    return type(first)(*(_gather(parts, n) for parts in zip(*results)))


def batch_over(fn: Callable, batch: WindowBatch, mesh: Mesh, *args,
               **kwargs):
    """``fn(sim, present, member, panels, *args, **kwargs)`` (one of the
    batch estimators here) on every ``data`` shard of ``batch``, each
    queued on its own device, then the results gathered in window order
    on the first device."""
    n = batch.sim.shape[0]
    shards = shard_batch(batch, mesh)
    results = []
    for shard in shards:
        with on_device(shard.sim.device):
            results.append(fn(*shard, *args, **kwargs))
    return _gather(results, n)


def batch_pi_panels(sim, present, member, panels, threshold) -> PiResult:
    """pica2 π for every (window, panel): PiResult of [W, P] fields.
    panels[w, p] is ANDed with member[w]; an empty panel gives π = 0 and
    n = 0."""
    return pi_grouped_panels(sim, present, member, panels, float(threshold))


class HudsonBatchResult(NamedTuple):
    direct: FstResult     # fields [W, Q]
    grouped: FstResult    # fields [W, Q]


def _host_pairs(pairs: Sequence[int] | torch.Tensor) -> List[int]:
    """Pair indices as host ints (indexing with them copies nothing to the
    device, ``stats.panelstats.take``)."""
    if isinstance(pairs, torch.Tensor):
        return pairs.tolist()
    return [int(i) for i in pairs]


def batch_hudson(sim, present, member, panels, pair_a, pair_b, threshold,
                 with_grouped: bool = True) -> HudsonBatchResult:
    """Hudson Fst for every (window, panel pair).

    pair_a / pair_b: the Q panel indices of the comparisons (a sequence or
    an integer tensor).  Members in both panels of a pair are stripped from
    both sides (h-fst.py:181-185).  The direct method is one masked-sums
    call for the batch; the grouped method groups all 2Q masks of a window
    in one pass, over chunks of windows that bound its [w, 2Q, N, N]
    temporaries.  Without ``with_grouped``, ``grouped`` repeats ``direct``.
    """
    ia, ib = _host_pairs(pair_a), _host_pairs(pair_b)
    mask_a = take(panels, ia, -2) & member[..., None, :]
    mask_b = take(panels, ib, -2) & member[..., None, :]
    overlap = mask_a & mask_b
    mask_a, mask_b = mask_a & ~overlap, mask_b & ~overlap
    direct = hudson_fst_direct_pairs(sim, present, mask_a, mask_b)
    if not with_grouped:
        return HudsonBatchResult(direct, direct)
    w, n_cap = sim.shape[0], sim.shape[-1]
    step = max(1, _HUDSON_CHUNK_ELEMS // max(1, 2 * len(ia) * n_cap * n_cap))
    parts = [hudson_fst_grouped_pairs(sim[lo:lo + step],
                                      present[lo:lo + step],
                                      mask_a[lo:lo + step],
                                      mask_b[lo:lo + step], float(threshold))
             for lo in range(0, w, step)]
    grouped = FstResult(*(torch.cat(f, dim=0) for f in zip(*parts)))
    return HudsonBatchResult(direct, grouped)


class Fst3PiBatchResult(NamedTuple):
    pi_a: torch.Tensor   # [W, Q] raw π
    pi_b: torch.Tensor
    pi_c: torch.Tensor   # π of the union A ∪ B
    pi_ab: torch.Tensor
    fst: torch.Tensor    # NaN where πC = 0


def batch_fst_3pi_panels(sim, present, member, panels, pair_a, pair_b,
                         threshold) -> Fst3PiBatchResult:
    """run_fst_impg.sh for every (window, panel pair): πA, πB and πC over
    A ∪ B (pica2 semantics) and Fst = (πC − πAB) / πC.  Each panel's π is
    computed once for all the pairs it is in: the P panels and the Q pair
    unions go through one :func:`pi_grouped_panels` call."""
    ia, ib = _host_pairs(pair_a), _host_pairs(pair_b)
    unions = take(panels, ia, -2) | take(panels, ib, -2)
    all_masks = torch.cat([panels, unions], dim=-2)
    pis = pi_grouped_panels(sim, present, member, all_masks,
                            float(threshold)).pi
    p_count = panels.shape[-2]
    pi_a, pi_b = take(pis, ia, -1), take(pis, ib, -1)
    pi_c = pis[..., p_count:]
    return Fst3PiBatchResult(pi_a, pi_b, pi_c, 0.5 * (pi_a + pi_b),
                             fst_3pi(pi_a, pi_b, pi_c))


def batch_allele_stats(geno, member, site_mask, max_n: int,
                       num_alleles: int = 2) -> AlleleWindowStats:
    """Direct π, S and the folded spectrum of W allele tiles [W, N, S]."""
    return allele_window_stats(geno, member, site_mask, max_n, num_alleles)


class TajdBatchResult(NamedTuple):
    pi: torch.Tensor   # [W, P] pica2-grouped π per site (run_tajd.sh:174)
    s: torch.Tensor    # [W] int32 segregating sites over the whole window
    n: torch.Tensor    # [W, P] f32 panel sizes
    d: torch.Tensor    # [W, P] f32 Tajima's D


def batch_tajd_from_alleles(geno, member, site_mask, panels, lengths,
                            threshold, num_alleles: int = 2
                            ) -> TajdBatchResult:
    """run_tajd.sh for every (window, panel): one allele tile feeds both
    the S branch and the π branch.

    Args: geno [W, N, S] int8, member [W, N], site_mask [W, S], panels
    [W, P, N] bool, lengths [W] (anything ``torch.as_tensor`` takes),
    threshold a float.  As in the reference, D takes the per-site π with
    the absolute S.
    """
    dev = geno.device
    lengths = torch.as_tensor(lengths, dtype=torch.float32, device=dev)
    sim, present = identity_from_alleles(geno, member, site_mask, lengths,
                                         num_alleles)
    s_count = segregating_sites(geno, member, site_mask)
    p_count = panels.shape[-2]
    res = pi_grouped(sim[:, None].expand(-1, p_count, -1, -1),
                     present[:, None].expand(-1, p_count, -1, -1),
                     member[:, None, :] & panels, threshold)
    pi_site = res.pi / torch.clamp(lengths, min=1.0)[:, None]
    d = tajimas_d(res.n, s_count.to(torch.float32)[:, None], pi_site)
    return TajdBatchResult(pi_site, s_count, res.n, d)
