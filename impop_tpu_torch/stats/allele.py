"""Statistics straight from haplotype-by-site allele tiles (port of
:mod:`impop_tpu.stats.allele`): identity (unit or column-mode weights), S,
the allele-frequency spectrum and the fused per-window bundle.

A window is an ``[N, S]`` int8 tile (1 alt, 0 ref, -1 missing or padding);
every function here takes any number of leading window axes.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["pairwise_diff", "pairwise_diff_biallelic", "identity_epilogue",
           "identity_from_alleles", "segregating_sites",
           "allele_frequency_spectrum", "panel_afs", "AlleleWindowStats",
           "allele_window_stats"]


def _valid(geno, member, site_mask):
    return (geno >= 0) & member[..., :, None] & site_mask[..., None, :]


def _gram(a, b):
    return a @ b.transpose(-1, -2)


def pairwise_diff_biallelic(geno: torch.Tensor, member: torch.Tensor,
                            site_mask: torch.Tensor,
                            site_weights: torch.Tensor | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(diff [..., N, N] f32, compared [..., N, N] f32) for 0/1 codes:
    diff = X(V−X)ᵀ + (V−X)Xᵀ over mutually valid sites, each site scaled by
    ``site_weights`` [..., S] when given (column-mode identity: an indel of
    k bases weighs k); compared = V·Vᵀ stays unweighted.  Exact while the
    weighted per-pair sums stay below 2^24 (float32, TF32 off on CUDA)."""
    valid = _valid(geno, member, site_mask)
    v = valid.to(torch.float32)
    x = torch.where(valid, geno, 0).to(torch.float32)
    xc = v - x
    xw, xcw = x, xc
    if site_weights is not None:
        w = site_weights.to(torch.float32)[..., None, :]
        xw, xcw = x * w, xc * w
    return _gram(xw, xc) + _gram(xcw, x), _gram(v, v)


def pairwise_diff(geno: torch.Tensor, member: torch.Tensor,
                  site_mask: torch.Tensor, num_alleles: int = 2,
                  site_weights: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Difference counts for allele codes 0..num_alleles-1: diff =
    compared_w − Σ_a (X==a)_w (X==a)ᵀ; biallelic codes take
    :func:`pairwise_diff_biallelic`."""
    if num_alleles == 2:
        return pairwise_diff_biallelic(geno, member, site_mask, site_weights)
    valid = _valid(geno, member, site_mask)
    v = valid.to(torch.float32)
    compared = _gram(v, v)
    w = (None if site_weights is None
         else site_weights.to(torch.float32)[..., None, :])
    compared_w = compared if w is None else _gram(v * w, v)
    match = torch.zeros_like(compared)
    for a in range(num_alleles):
        xa = (torch.where(valid, geno, -1) == a).to(torch.float32)
        match = match + _gram(xa if w is None else xa * w, xa)
    return compared_w - match, compared


def identity_epilogue(diff: torch.Tensor, compared: torch.Tensor,
                      member: torch.Tensor, length
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's sim/present from difference and comparison counts:
    present = compared > 0 ∧ both members, sim = 1 − diff / max(length, 1)
    there (0 elsewhere), and the member diagonal forced to sim 1, present
    (a member with no valid call still presents its self-pair)."""
    present = (compared > 0) & member[..., :, None] & member[..., None, :]
    length = torch.as_tensor(length, dtype=torch.float32, device=diff.device)
    denom = torch.clamp(length, min=1.0)[..., None, None]
    sim = torch.where(present, 1.0 - diff / denom, 0.0)
    n_cap = diff.shape[-1]
    diag = (torch.eye(n_cap, dtype=torch.bool, device=diff.device)
            & member[..., :, None])
    sim = torch.where(diag, 1.0, sim)
    return sim, present | diag


def identity_from_alleles(geno: torch.Tensor, member: torch.Tensor,
                          site_mask: torch.Tensor, length,
                          num_alleles: int = 2,
                          site_weights: torch.Tensor | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Identity matrix ``1 - diff / max(length, 1)`` and its presence mask.

    - Unit weights, ``num_alleles == 2``: ``ops.pairdiff.pairwise_identity``
      (the unit-weight identity kernel on CUDA tensors, every S), the
      z-Gram ``diff = (v·vᵀ − z·zᵀ) / 2`` with z = 2·max(g, 0) − v.
    - ``site_weights`` [..., S], ``num_alleles == 2``: column-mode identity
      through ``ops.pairdiff.pairwise_identity_weighted``.
    - ``num_alleles > 2``: :func:`pairwise_diff` in plain PyTorch (the JAX
      package leaves this branch to XLA too).

    Args:
      geno: [..., N, S] int8; member: [..., N] bool; site_mask: [..., S]
        bool; length: scalar or [...] window length in bp.
    Returns: (sim [..., N, N] f32, present [..., N, N] bool).
    """
    if num_alleles != 2:
        diff, compared = pairwise_diff(geno, member, site_mask, num_alleles,
                                       site_weights)
        return identity_epilogue(diff, compared, member, length)
    if site_weights is not None:
        from impop_tpu_torch.ops.pairdiff import pairwise_identity_weighted

        return pairwise_identity_weighted(geno, member, site_mask, length,
                                          site_weights)
    from impop_tpu_torch.ops.pairdiff import pairwise_identity

    return pairwise_identity(geno, member, site_mask, length)


def segregating_sites(geno: torch.Tensor, member: torch.Tensor,
                      site_mask: torch.Tensor) -> torch.Tensor:
    """S = number of columns whose largest valid code exceeds the smallest
    (>= 2 distinct valid alleles), [...] int32."""
    valid = _valid(geno, member, site_mask)
    g = geno.to(torch.int32)
    big = torch.iinfo(torch.int32).max
    col_min = torch.where(valid, g, big).amin(dim=-2)
    col_max = torch.where(valid, g, -1).amax(dim=-2)
    return (col_max > col_min).sum(dim=-1, dtype=torch.int32)


def allele_frequency_spectrum(geno: torch.Tensor, member: torch.Tensor,
                              site_mask: torch.Tensor, max_n: int,
                              folded: bool = True) -> torch.Tensor:
    """counts[..., k] = number of polymorphic sites whose alt (folded:
    minor) allele count is k, k in [0, max_n] ([..., max_n + 1] int32)."""
    valid = _valid(geno, member, site_mask)
    ones = torch.where(valid, geno, 0).to(torch.int32).sum(dim=-2,
                                                           dtype=torch.int32)
    total = valid.sum(dim=-2, dtype=torch.int32)
    poly = (ones > 0) & (ones < total)
    count = torch.minimum(ones, total - ones) if folded else ones
    count = torch.where(poly, count, 0).clamp(0, max_n)
    hist = torch.zeros((*count.shape[:-1], max_n + 1), dtype=torch.int32,
                       device=geno.device)
    return hist.scatter_add_(-1, count.to(torch.int64),
                             poly.to(torch.int32))


def panel_afs(geno: torch.Tensor, member: torch.Tensor,
              site_mask: torch.Tensor, panels: torch.Tensor, max_n: int,
              folded: bool = True) -> torch.Tensor:
    """Per-panel spectra [..., P, max_n + 1] int32; panel masks [..., P, N]
    are ANDed with ``member``."""
    return allele_frequency_spectrum(
        geno[..., None, :, :], panels & member[..., None, :],
        site_mask[..., None, :], max_n, folded)


class AlleleWindowStats(NamedTuple):
    pi_direct: torch.Tensor  # [...] f32 mean pairwise difference count
    s: torch.Tensor          # [...] int32 segregating sites
    n: torch.Tensor          # [...] int32 member haplotypes
    afs: torch.Tensor        # [..., max_n + 1] int32 folded spectrum


def allele_window_stats(geno: torch.Tensor, member: torch.Tensor,
                        site_mask: torch.Tensor, max_n: int,
                        num_alleles: int = 2) -> AlleleWindowStats:
    """Direct π (mean difference count over pairs compared at one site or
    more), S and the folded spectrum of each window, in plain PyTorch as
    the JAX package leaves them to XLA."""
    diff, compared = pairwise_diff(geno, member, site_mask, num_alleles)
    n_cap = member.shape[-1]
    offdiag = ~torch.eye(n_cap, dtype=torch.bool, device=geno.device)
    pair_ok = (compared > 0) & offdiag
    total = torch.where(pair_ok, diff, 0.0).sum(dim=(-2, -1)) * 0.5
    pairs = pair_ok.sum(dim=(-2, -1), dtype=torch.float32) * 0.5
    pi = torch.where(pairs > 0, total / torch.clamp(pairs, min=1.0), 0.0)
    return AlleleWindowStats(
        pi, segregating_sites(geno, member, site_mask),
        member.sum(dim=-1, dtype=torch.int32),
        allele_frequency_spectrum(geno, member, site_mask, max_n))
