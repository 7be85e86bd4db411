"""Identity from allele tiles for a batch of windows (port of
``impop_tpu.ops.pairdiff``: ``pairwise_identity_pallas`` in both its
unit-weight schedules, ``_pairwise_identity_pallas_i8``, and the weighted
branch).

Unit weights, with v = valid (call >= 0, member row, active site) and
z = 2·max(g, 0) − v on valid cells (0 elsewhere):

    compared = v·vᵀ,  diff = (v·vᵀ − z·zᵀ) / 2

Column-mode weights:

    diff = Σ_s w_s (a_i c_j + c_i a_j),  compared = Σ_s v_i v_j

and in both

    present = compared > 0 ∧ member_i ∧ member_j
    sim = 1 − diff / max(length, 1) where present, the member diagonal 1

- :func:`pairwise_identity_plain` / :func:`pairwise_identity_weighted_plain`:
  float32 ``torch.matmul`` Grams (TF32 off on CUDA), then the reference's
  epilogue.
- :func:`pairwise_identity` / :func:`pairwise_identity_weighted`: the
  wrappers.  CPU tensors take the plain version; CUDA tensors launch
  ``pairwise_identity_kernel`` (int8 operands, exact int32 ``__dp4a``
  sums over i ≤ j tile pairs, mirrored) or ``weighted_identity_kernel``
  (a tiled fp32 kernel) of ``csrc/pairdiff.cu``, every N and S, or raise.

The unit-weight z-Gram is the polynomial ``x(v−x)ᵀ + (v−x)xᵀ`` of the
reference's CPU path for any code x, so codes above 1 agree too.  Counts
are exact integers below 2^24 on every path, so sim and present are equal,
not close; so are weighted sums with integer weights (indel lengths).
"""
from __future__ import annotations

import math

import torch

from impop_tpu_torch.stats.allele import (_valid, identity_epilogue,
                                          pairwise_diff_biallelic)

__all__ = ["pairwise_identity", "pairwise_identity_plain",
           "pairwise_identity_weighted", "pairwise_identity_weighted_plain"]


def pairwise_identity_plain(geno, member, site_mask, length
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(sim [..., N, N] f32, present [..., N, N] bool), any device."""
    valid = _valid(geno, member, site_mask)
    v = valid.to(torch.float32)
    z = torch.where(valid, 2.0 * geno.clamp(min=0).to(torch.float32) - 1.0,
                    0.0)
    vv = v @ v.transpose(-1, -2)
    zz = z @ z.transpose(-1, -2)
    return identity_epilogue((vv - zz) * 0.5, vv, member, length)


def _window_args(what, geno, member, site_mask, length, extra=()):
    """Checked, contiguous kernel arguments: (lead, n, s, w, geno, member
    u8, site_mask u8, length f32 [W])."""
    from impop_tpu_torch.ops._build import u8_mask

    dev = geno.device
    lead = tuple(geno.shape[:-2])
    n, s = geno.shape[-2:]
    if geno.dtype != torch.int8:
        raise ValueError(f"{what}: geno must be int8, got {geno.dtype}")
    w = math.prod(lead)
    if w > 65535:
        raise ValueError(f"{what}: {w} windows exceed the grid's 65535")
    if not isinstance(length, torch.Tensor):
        length = torch.full(lead, float(length), device=dev)
    for name, t in (("member", member), ("site_mask", site_mask),
                    ("length", length)) + tuple(extra):
        if t.device != dev:
            raise ValueError(f"{what}: {name} on {t.device}, geno on {dev}")
    mem = u8_mask(member, what, "member", lead + (n,))
    smk = u8_mask(site_mask, what, "site_mask", lead + (s,))
    lens = length.to(torch.float32).expand(lead).contiguous()
    return lead, n, s, w, geno.contiguous(), mem, smk, lens


def _pairwise_identity_cuda(geno, member, site_mask, length):
    from impop_tpu_torch.ops._build import check, load_library

    what = "pairwise_identity"
    lead, n, s, w, genc, mem, smk, lens = _window_args(
        what, geno, member, site_mask, length)
    sim = torch.empty(lead + (n, n), dtype=torch.float32, device=geno.device)
    pres = torch.empty(lead + (n, n), dtype=torch.uint8, device=geno.device)
    if w > 0 and n > 0:
        lib = load_library()
        stream = torch.cuda.current_stream(geno.device).cuda_stream
        err = lib.impop_pairwise_identity(
            genc.data_ptr(), mem.data_ptr(), smk.data_ptr(), lens.data_ptr(),
            w, n, s, sim.data_ptr(), pres.data_ptr(), stream)
        check(lib, err, "pairwise_identity_kernel")
        pairwise_identity.launches += 1
    return sim, pres.view(torch.bool)


def pairwise_identity(geno: torch.Tensor, member: torch.Tensor,
                      site_mask: torch.Tensor, length
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Unit-weight identity of a batch of windows.

    Args:
      geno:      [..., N, S] int8 (allele codes, -1 missing); the kernel is
                 exact for codes up to 63 (z = 2g − 1 must fit int8)
      member:    [..., N] bool;  site_mask: [..., S] bool
      length:    [...] window length in bp (or a scalar)
    Returns (sim [..., N, N] f32, present [..., N, N] bool).
    """
    if geno.device.type == "cpu":
        return pairwise_identity_plain(geno, member, site_mask, length)
    if geno.device.type == "cuda":
        return _pairwise_identity_cuda(geno, member, site_mask, length)
    raise ValueError(f"pairwise_identity: unsupported device {geno.device}")


pairwise_identity.launches = 0


def pairwise_identity_weighted_plain(geno, member, site_mask, length,
                                     site_weights
                                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(sim [..., N, N] f32, present [..., N, N] bool), any device."""
    diff, compared = pairwise_diff_biallelic(geno, member, site_mask,
                                             site_weights)
    return identity_epilogue(diff, compared, member, length)


def _weighted_identity_cuda(geno, member, site_mask, length, site_weights):
    from impop_tpu_torch.ops._build import check, load_library

    what = "pairwise_identity_weighted"
    lead, n, s, w, genc, mem, smk, lens = _window_args(
        what, geno, member, site_mask, length,
        (("site_weights", site_weights),))
    wts = site_weights.to(torch.float32).expand(lead + (s,)).contiguous()
    sim = torch.empty(lead + (n, n), dtype=torch.float32, device=geno.device)
    pres = torch.empty(lead + (n, n), dtype=torch.uint8, device=geno.device)
    if w > 0 and n > 0:
        lib = load_library()
        stream = torch.cuda.current_stream(geno.device).cuda_stream
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
