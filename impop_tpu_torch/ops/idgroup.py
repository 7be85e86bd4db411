"""Fused identity + greedy grouping + S for a batch of windows (port of
``impop_tpu.ops.idgroup.identity_group_pallas``).

- :func:`identity_group_plain`: the composition the TPU kernel is held to
  (``tests/test_ops.py``): the unit-weight identity, the greedy grouping of
  every mask and the segregating-site count, all in plain PyTorch.
- :func:`identity_group`: the wrapper.  CPU tensors take the plain
  version; CUDA tensors launch ``csrc/idgroup.cu`` (three launches over
  many blocks per window: the window kernel's pack, its 32 x 32 pair
  blocks writing sim and present with their mirrors and the link words,
  and the seed peel's walk writing gid), or raise.
"""
from __future__ import annotations

import math

import torch

from impop_tpu_torch.ops.pairdiff import pairwise_identity_plain
from impop_tpu_torch.ops.seedpeel import _aligned, seed_gid_plain
from impop_tpu_torch.stats.allele import segregating_sites
from impop_tpu_torch.stats.grouping import greedy_group_panels

__all__ = ["identity_group", "identity_group_plain"]

# The pair launch puts the 32 x 32 blocks on or above the diagonal, eight a
# block, on grid y (at most 65 535 blocks): N / 32 = 1023 is the largest fit.
_MAX_N = 32 * 1023


def identity_group_plain(geno, member, site_mask, pmasks, threshold, length):
    """(sim [..., N, N] f32, present [..., N, N] bool, gid [..., R, N]
    int32, S [...] f32), any device, no kernel."""
    sim, present = pairwise_identity_plain(geno, member, site_mask, length)
    gid = greedy_group_panels(sim, present, member, pmasks, threshold,
                              peel=seed_gid_plain)
    s_count = segregating_sites(geno, member, site_mask).to(torch.float32)
    return sim, present, gid, s_count


def _identity_group_cuda(geno, member, site_mask, pmasks, threshold, length):
    from impop_tpu_torch.ops._build import check, load_library, u8_mask

    what = "identity_group"
    dev = geno.device
    lead = tuple(geno.shape[:-2])
    n, s = geno.shape[-2:]
    r_count = pmasks.shape[-2]
    if geno.dtype != torch.int8:
        raise ValueError(f"{what}: geno must be int8, got {geno.dtype}")
    if n % 32 or s % 32 or n == 0 or s == 0 or n > _MAX_N:
        raise ValueError(f"{what}: caps N={n}, S={s} must be positive "
                         f"multiples of 32, N at most {_MAX_N} (the pair "
                         "launch's grid)")
    if not isinstance(length, torch.Tensor):
        length = torch.full(lead, float(length), device=dev)
    for name, t in (("member", member), ("site_mask", site_mask),
                    ("pmasks", pmasks), ("length", length)):
        if t.device != dev:
            raise ValueError(f"{what}: {name} on {t.device}, geno on {dev}")
    w = math.prod(lead)
    # the walk reads member and the masks 16 bytes at a time
    mem = _aligned(u8_mask(member, what, "member", lead + (n,)))
    smk = u8_mask(site_mask, what, "site_mask", lead + (s,))
    pmk = _aligned(u8_mask(pmasks, what, "pmasks", lead + (r_count, n)))
    lens = length.to(torch.float32).expand(lead).contiguous()
    genc = geno.contiguous()
    sim = torch.empty(lead + (n, n), dtype=torch.float32, device=dev)
    pres = torch.empty(lead + (n, n), dtype=torch.uint8, device=dev)
    gid = torch.empty(lead + (r_count, n), dtype=torch.int32, device=dev)
    s_count = torch.empty(lead, dtype=torch.float32, device=dev)
    if w > 0:
        bits = torch.empty((w, 2, s // 32, n), dtype=torch.int32, device=dev)
        colbits = torch.zeros((w, 2, s // 32), dtype=torch.int32, device=dev)
        link = torch.empty((w, n, n // 32), dtype=torch.int32, device=dev)
        lib = load_library()
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.impop_identity_group(
            genc.data_ptr(), mem.data_ptr(), smk.data_ptr(), pmk.data_ptr(),
            lens.data_ptr(), float(threshold), w, n, s, r_count,
            bits.data_ptr(), colbits.data_ptr(), link.data_ptr(),
            sim.data_ptr(), pres.data_ptr(), gid.data_ptr(),
            s_count.data_ptr(), stream)
        check(lib, err, "idgroup_pack_kernel / idgroup_pairs_kernel / "
              "seed_peel_kernel")
        identity_group.launches += 1
    return sim, pres.view(torch.bool), gid, s_count


def identity_group(geno: torch.Tensor, member: torch.Tensor,
                   site_mask: torch.Tensor, pmasks: torch.Tensor, threshold,
                   length):
    """Identity, greedy groups of every mask and S of a batch of windows.

    Args:
      geno:      [..., N, S] int8, biallelic codes (1 alt, 0 ref, -1
                 missing): the kernel's domain, as the TPU kernel's
      member:    [..., N] bool;  site_mask: [..., S] bool
      pmasks:    [..., R, N] bool mask stack (ANDed with member)
      threshold: float (strict > link rule, compared in f32)
      length:    [...] window length in bp (or a scalar)
    Returns (sim [..., N, N] f32, present [..., N, N] bool, gid [..., R, N]
    int32 (seed row per mask member, N elsewhere), S [...] f32).
    """
    if geno.device.type == "cpu":
        return identity_group_plain(geno, member, site_mask, pmasks,
                                    threshold, length)
    if geno.device.type == "cuda":
        return _identity_group_cuda(geno, member, site_mask, pmasks,
                                    threshold, length)
    raise ValueError(f"identity_group: unsupported device {geno.device}")


identity_group.launches = 0
