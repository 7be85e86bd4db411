"""Identity and S straight from haplotype-by-site allele tiles (the unit-weight
part of :mod:`impop_tpu.stats.allele`).

A window is an ``[N, S]`` int8 tile (1 alt, 0 ref, -1 missing or padding);
every function here takes any number of leading window axes.
"""
from __future__ import annotations

import torch

__all__ = ["identity_from_alleles", "segregating_sites"]


def _valid(geno, member, site_mask):
    return (geno >= 0) & member[..., :, None] & site_mask[..., None, :]


def identity_from_alleles(geno: torch.Tensor, member: torch.Tensor,
                          site_mask: torch.Tensor, length
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Identity matrix ``1 - diff / max(length, 1)`` and its presence mask.

    z-Gram form: z = +1 alt / -1 ref / 0 invalid, v = |z|, so
    ``diff = (v·vᵀ − z·zᵀ) / 2`` counts mutually valid sites that differ.
    The operands are 0/±1 and the counts stay below 2^24, so the float32
    products are exact in any summation order.  ``present`` covers pairs
    with at least one mutually valid site, plus the member diagonal (a
    member with no valid call still presents its self-pair).

    Args:
      geno: [..., N, S] int8; member: [..., N] bool; site_mask: [..., S]
        bool; length: scalar or [...] window length in bp.
    Returns: (sim [..., N, N] f32, present [..., N, N] bool).
    """
    valid = _valid(geno, member, site_mask)
    v = valid.to(torch.float32)
    z = torch.where(valid, torch.where(geno > 0, 1.0, -1.0), 0.0)
    zz = z @ z.transpose(-1, -2)
    vv = v @ v.transpose(-1, -2)
    diff = (vv - zz) * 0.5
    present = (vv > 0) & member[..., :, None] & member[..., None, :]
    length = torch.as_tensor(length, dtype=torch.float32, device=geno.device)
    denom = torch.clamp(length, min=1.0)[..., None, None]
    sim = torch.where(present, 1.0 - diff / denom, 0.0)
    n_cap = geno.shape[-2]
    diag = (torch.eye(n_cap, dtype=torch.bool, device=geno.device)
            & member[..., :, None])
    sim = torch.where(diag, 1.0, sim)
    return sim, present | diag


def segregating_sites(geno: torch.Tensor, member: torch.Tensor,
                      site_mask: torch.Tensor) -> torch.Tensor:
    """S = number of columns with a valid 0 and a valid 1 ([...] int32)."""
    valid = _valid(geno, member, site_mask)
    any_alt = (valid & (geno > 0)).any(dim=-2)
    any_ref = (valid & (geno == 0)).any(dim=-2)
    return (any_alt & any_ref).sum(dim=-1, dtype=torch.int32)
