"""Extended Haplotype Homozygosity (port of ``impop_tpu.stats.ehh``).

EHH(i) is the fraction of haplotype pairs identical on every site of the
prefix 0..i.  A pair stays identical up to its death site, the first
active site where it disagrees, so both the curves and the areas come from
death sites:

- curves (:func:`ehh_forward`, :func:`ehh_bidirectional`,
  :func:`ehh_decay_from_focal`): EHH(i) = #pairs with death > i / C(n, 2),
  from :func:`ehh_pair_death` in plain PyTorch on the caller's device;
- areas (:func:`ehh_area_batch`, :func:`ehh_area_dynamic`): the area under
  a focal site's decay curve is Σ_pairs steps(pair) / C(n_c, 2), where a
  pair of carriers of one allele adds one step for every ACTIVE site,
  walking away from the focal column, that it stays identical on.  The
  step sums come from ``ops.ehhdeath.ehh_area`` (the EHH kernel on CUDA
  tensors) in int64 and are divided by max(C(n_c, 2), 1) in float32.

Steps count active sites only, so an area does not depend on the tile's
padding: a window padded with masked columns (the ragged tail of the
``ehh`` command, a tile padded to a batch's width) gives the area of the
window with those columns dropped.  The JAX ``ehh_area_batch`` counts
masked columns between the focal and a death site as steps; on unpadded
windows the two agree.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Union

import torch

from impop_tpu_torch.ops.ehhdeath import ehh_area

__all__ = ["ehh_forward", "ehh_bidirectional", "ehh_pair_death",
           "EhhResult", "ehh_decay_from_focal", "ehh_batch_tiles",
           "ehh_area_batch", "ehh_area_dynamic"]

_DEATH_CHUNK_ELEMS = 1 << 24     # [N, N, sites] comparisons per step


def ehh_pair_death(geno: torch.Tensor, site_mask: torch.Tensor
                   ) -> torch.Tensor:
    """First active site where each haplotype pair differs; S where the
    pair agrees on every active site.  ``geno`` [N, S] (any codes: a pair
    differs where its codes differ), ``site_mask`` [S] bool.  Returns
    [N, N] int32."""
    n, s = geno.shape
    death = torch.full((n, n), s, dtype=torch.int32, device=geno.device)
    step = max(1, _DEATH_CHUNK_ELEMS // max(n * n, 1))
    sm = site_mask.bool()
    for lo in range(0, s, step):
        g = geno[:, lo:lo + step]
        diff = (g[:, None, :] != g[None, :, :]) & sm[lo:lo + step]
        first = diff.to(torch.uint8).argmax(-1).to(torch.int32) + lo
        death = torch.where((death == s) & diff.any(-1), first, death)
    return death


def _pair_mask(member: torch.Tensor) -> torch.Tensor:
    n = member.shape[0]
    upper = torch.ones((n, n), dtype=torch.bool,
                       device=member.device).triu(1)
    return upper & member[:, None] & member[None, :]


def ehh_forward(geno: torch.Tensor, member: torch.Tensor,
                site_mask: torch.Tensor) -> torch.Tensor:
    """EHH over the growing prefixes [0..i] of ``geno`` [N, S]: the share
    of member pairs that agree on every active site of the prefix (masked
    sites count as agreeing).  Returns [S] float32."""
    s = geno.shape[1]
    pairs = _pair_mask(member.bool())
    n = member.bool().sum(dtype=torch.int32).to(torch.float32)
    denom = torch.clamp(n * (n - 1.0) * 0.5, min=1.0)
    death = ehh_pair_death(geno, site_mask)[pairs].to(torch.int64)
    dead_by = torch.bincount(death, minlength=s + 1)[:s].cumsum(0)
    alive = pairs.sum(dtype=torch.int64) - dead_by
    return alive.to(torch.float32) / denom


def ehh_bidirectional(geno: torch.Tensor, member: torch.Tensor,
                      site_mask: torch.Tensor) -> torch.Tensor:
    """[reversed EHH of the flipped matrix, forward EHH], [2S] float32."""
    fwd = ehh_forward(geno, member, site_mask)
    rev = ehh_forward(geno.flip(-1), member, site_mask.flip(-1))
    return torch.cat([rev.flip(-1), fwd])


class EhhResult(NamedTuple):
    ehh: torch.Tensor       # [2 (S - 1)] decay curve: left reversed ++ right
    area: torch.Tensor      # scalar float32, the sum of the curve
    carriers: torch.Tensor  # scalar int32, haplotypes carrying the allele


def ehh_decay_from_focal(geno: torch.Tensor, member: torch.Tensor,
                         site_mask: torch.Tensor, focal: int,
                         allele: int) -> EhhResult:
    """EHH decay away from column ``focal`` for the members whose call
    there is ``allele``: EHH rightward on the suffix after the focal,
    leftward on the reversed prefix before it, concatenated (left
    reversed first) and summed into the area."""
    carriers = member.bool() & (geno[:, focal] == allele)
    empty = torch.zeros((0,), dtype=torch.float32, device=geno.device)
    left = (ehh_forward(geno[:, :focal].flip(-1), carriers,
                        site_mask[:focal].flip(-1)) if focal > 0 else empty)
    right = (ehh_forward(geno[:, focal + 1:], carriers,
                         site_mask[focal + 1:])
             if focal + 1 < geno.shape[1] else empty)
    curve = torch.cat([left.flip(-1), right])
    return EhhResult(curve, curve.sum(), carriers.sum(dtype=torch.int32))


def _compat_tiles(geno, site_mask, focal):
    """[R | focal | R] per window, R = the columns right of the focal with
    their site mask: the focal at column F = the widest R of the batch,
    each window's R ending at F - 1 and starting at F + 1, inactive
    columns around them.  The kernel's leftward walk then reads R from its
    last column to its first."""
    w, _, s = geno.shape
    r = s - 1 - focal                                          # [W]
    big = int(r.max())
    c = torch.arange(2 * big + 1, device=geno.device)[None, :]
    d = c - big                                                # distance
    src = torch.where(d < 0, s + d, focal[:, None] + d)
    valid = d.abs() <= r[:, None]
    src = torch.where(valid, src, 0)
    tile = torch.gather(geno, 2, src[:, None, :].expand(-1, geno.shape[1],
                                                        -1))
    active = valid & torch.gather(site_mask, 1, src)
    return tile, active, torch.full_like(focal, big)


def ehh_batch_tiles(geno: torch.Tensor, member: torch.Tensor,
                    site_mask: torch.Tensor,
                    focal: Union[int, torch.Tensor],
                    compat_right_for_left: bool = False
                    ) -> tuple[torch.Tensor, ...]:
    """The ``ops.ehhdeath.ehh_area`` arguments of :func:`ehh_area_batch`
    (arguments as there): the batch with each focal column active, so that
    the kernel's walks start next to it; with ``compat_right_for_left``
    each tile is [R | focal | R]."""
    w, _, s = geno.shape
    dev = geno.device
    foc = torch.as_tensor(focal, dtype=torch.int64, device=dev).expand(w)
    if w and (int(foc.min()) < 0 or int(foc.max()) >= s):
        raise ValueError(f"ehh_area_batch: focal outside the {s} columns")
    sm = site_mask.bool()
    if compat_right_for_left and w:
        geno, sm, foc = _compat_tiles(geno, sm, foc)
    col = torch.arange(geno.shape[-1], device=dev)[None, :]
    return geno, member, sm | (col == foc[:, None]), foc


def ehh_area_batch(geno: torch.Tensor, member: torch.Tensor,
                   site_mask: torch.Tensor,
                   focal: Union[int, torch.Tensor],
                   alleles: Sequence[int] = (0, 1),
                   compat_right_for_left: bool = False
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """EHH decay areas of alleles 0 and 1 at each window's focal column,
    one ``ehh_area`` launch for the batch.

    Args:
      geno:      [W, N, S] int8 binarised 0/1 windows (masked columns may
                 hold anything)
      member:    [W, N] bool (padded rows False)
      site_mask: [W, S] bool
      focal:     focal column, an int for every window or [W] ints
      alleles:   must be (0, 1), the alleles the kernel counts
      compat_right_for_left: the reference's use of the right suffix for
                 both directions: the left area is the decay over the
                 right suffix read from its end (tile [R | focal | R])
    Returns (area [W, 2] float32, carriers [W, 2] int32).

    The left and right step sums come from one launch over
    :func:`ehh_batch_tiles`, so that each area is left / C + right / C in
    float32, as the JAX package rounds it.  On CUDA tensors this is the
    EHH kernel or an error, never the plain version.
    """
    if tuple(int(a) for a in alleles) != (0, 1):
        raise ValueError(f"ehh_area_batch: alleles must be (0, 1), the "
                         f"alleles the EHH kernel counts; got {alleles}")
    sums, carr = ehh_area(*ehh_batch_tiles(geno, member, site_mask, focal,
                                           compat_right_for_left))
    c = carr.to(torch.float32)
    denom = torch.clamp(c * (c - 1.0) * 0.5, min=1.0)
    area = (sums[:, 0].to(torch.float32) / denom
            + sums[:, 1].to(torch.float32) / denom)
    return area, carr


def ehh_area_dynamic(geno: torch.Tensor, member: torch.Tensor,
                     site_mask: torch.Tensor, focal: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Bidirectional EHH decay areas for alleles (0, 1) at each window's
    focal column (the fused scan's form).

    ``geno`` is binarised as (call == 1), so a missing call counts as
    allele 0; carriers of allele a are members whose raw focal call
    binarises to a.

    Args:
      geno: [..., N, S] int8; member: [..., N] bool; site_mask: [..., S]
        bool; focal: [...] int focal column index.
    Returns (area [..., 2] f32, carriers [..., 2] int32).
    """
    sums, carr = ehh_area(geno, member, site_mask, focal)
    n_c = carr.to(torch.float32)
    denom = torch.clamp(n_c * (n_c - 1.0) * 0.5, min=1.0)
    return sums.sum(-2).to(torch.float32) / denom, carr
