"""Weighted (column-mode) identity for a batch of windows (port of the
weighted branch of ``impop_tpu.ops.pairdiff.pairwise_identity_pallas``).

    diff = Σ_s w_s (a_i c_j + c_i a_j),  compared = Σ_s v_i v_j
    present = compared > 0 ∧ member_i ∧ member_j
    sim = 1 − diff / max(length, 1) where present, the member diagonal 1

- :func:`pairwise_identity_weighted_plain`:
  ``stats.allele.pairwise_diff_biallelic`` with the weights, then the
  reference's epilogue.
- :func:`pairwise_identity_weighted`: the wrapper.  CPU tensors take the
  plain version; CUDA tensors launch ``weighted_identity_kernel`` of
  ``csrc/pairdiff.cu`` (a tiled fp32 kernel over the [N, N] output, every
  S), or raise.

With integer weights whose per-pair sum stays below 2^24 (indel lengths)
both compute exact integer sums, so sim and present are equal, not close.
"""
from __future__ import annotations

import math

import torch

from impop_tpu_torch.stats.allele import (identity_epilogue,
                                          pairwise_diff_biallelic)

__all__ = ["pairwise_identity_weighted", "pairwise_identity_weighted_plain"]


def pairwise_identity_weighted_plain(geno, member, site_mask, length,
                                     site_weights
                                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(sim [..., N, N] f32, present [..., N, N] bool), any device."""
    diff, compared = pairwise_diff_biallelic(geno, member, site_mask,
                                             site_weights)
    return identity_epilogue(diff, compared, member, length)


def _weighted_identity_cuda(geno, member, site_mask, length, site_weights):
    from impop_tpu_torch.ops._build import check, load_library, u8_mask

    dev = geno.device
    lead = tuple(geno.shape[:-2])
    n, s = geno.shape[-2:]
    if geno.dtype != torch.int8:
        raise ValueError("pairwise_identity_weighted: geno must be int8, got "
                         f"{geno.dtype}")
    w = math.prod(lead)
    if w > 65535:
        raise ValueError(f"pairwise_identity_weighted: {w} windows exceed "
                         "the grid's 65535")
    if not isinstance(length, torch.Tensor):
        length = torch.full(lead, float(length), device=dev)
    for name, t in (("member", member), ("site_mask", site_mask),
                    ("length", length), ("site_weights", site_weights)):
        if t.device != dev:
            raise ValueError(f"pairwise_identity_weighted: {name} on "
                             f"{t.device}, geno on {dev}")
    what = "pairwise_identity_weighted"
    mem = u8_mask(member, what, "member", lead + (n,))
    smk = u8_mask(site_mask, what, "site_mask", lead + (s,))
    wts = site_weights.to(torch.float32).expand(lead + (s,)).contiguous()
    lens = length.to(torch.float32).expand(lead).contiguous()
    genc = geno.contiguous()
    sim = torch.empty(lead + (n, n), dtype=torch.float32, device=dev)
    pres = torch.empty(lead + (n, n), dtype=torch.uint8, device=dev)
    if w > 0 and n > 0:
        lib = load_library()
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.impop_weighted_identity(
            genc.data_ptr(), mem.data_ptr(), smk.data_ptr(), wts.data_ptr(),
            lens.data_ptr(), w, n, s, sim.data_ptr(), pres.data_ptr(),
            stream)
        check(lib, err, "weighted_identity_kernel")
        pairwise_identity_weighted.launches += 1
    return sim, pres.view(torch.bool)


def pairwise_identity_weighted(geno: torch.Tensor, member: torch.Tensor,
                               site_mask: torch.Tensor, length,
                               site_weights: torch.Tensor
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Column-mode identity of a batch of biallelic windows.

    Args:
      geno:         [..., N, S] int8 (1 alt, 0 ref, -1 missing)
      member:       [..., N] bool;  site_mask: [..., S] bool
      length:       [...] window length in bp (or a scalar)
      site_weights: [..., S] f32 per-site diff weights
    Returns (sim [..., N, N] f32, present [..., N, N] bool).
    """
    if geno.device.type == "cpu":
        return pairwise_identity_weighted_plain(geno, member, site_mask,
                                                length, site_weights)
    if geno.device.type == "cuda":
        return _weighted_identity_cuda(geno, member, site_mask, length,
                                       site_weights)
    raise ValueError("pairwise_identity_weighted: unsupported device "
                     f"{geno.device}")


pairwise_identity_weighted.launches = 0
