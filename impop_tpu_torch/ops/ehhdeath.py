"""EHH death sites and per-allele step sums for a batch of windows (port of
``impop_tpu.ops.ehhdeath.ehh_area_pallas`` with the compaction and carrier
selection of ``impop_tpu.stats.ehh.ehh_area_dynamic``).

Per window, xb = (call == 1) at active sites, compacted by rank; fi = the
number of active sites left of the focal column, n_act the number of
active sites; carriers of allele a are members whose raw focal call
binarises to a (a focal outside the tile reads as allele 0).  For every
pair i < j of carriers of one allele the step count is

    max(min(first differing rank > fi, n_act) - fi - 1, 0)
      + max(fi - 1 - last differing rank < fi (else -1), 0)

and the outputs are the step sums per direction (left: the second term,
right: the first) and allele, ``[..., 2, 2]`` int64 (C(N, 2) * S passes
2^24 at N = 512, S = 128, so no float accumulator is exact), and the
carrier counts, ``[..., 2]`` int32.

- :func:`ehh_area_plain`: the same sums by a scan over ranks that carries
  each pair's "still identical" flag, in int64.
- :func:`ehh_area`: the wrapper.  CPU tensors take the plain version; CUDA
  tensors launch ``csrc/ehhdeath.cu`` or raise: ``ehh_pack_kernel`` (32
  rows per block: rows rank-compacted into 64-bit words, the carrier list
  of each allele in ascending row order) and ``ehh_pairs_kernel`` (64 x 64
  tiles of one allele's list, so only same-allele pairs are walked; death
  ranks by bit scans over words staged in shared memory, both directions
  in one walk, int64 sums by integer atomics).  The pair walks bound it; see the source.
"""
from __future__ import annotations

import math

import torch

from impop_tpu_torch.device import on_device

__all__ = ["ehh_area", "ehh_area_plain"]


def ehh_area_plain(geno: torch.Tensor, member: torch.Tensor,
                   site_mask: torch.Tensor, focal: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(sums [..., 2, 2] int64, carriers [..., 2] int32), any device."""
    lead = geno.shape[:-2]
    n, s = geno.shape[-2:]
    dev = geno.device
    g = geno.reshape(-1, n, s)
    w = g.shape[0]
    mem = member.reshape(w, n).bool()
    sm = site_mask.reshape(w, s).bool()
    f = focal.reshape(w).to(torch.int64)

    act = sm.to(torch.int64)
    rank = act.cumsum(-1) - act
    n_act = act.sum(-1)
    fi = (act * (torch.arange(s, device=dev) < f[:, None])).sum(-1)
    # compacted xb: active column s goes to column rank[s], inactive ones to
    # a dump column past the end
    xb = ((g == 1) & sm[:, None, :]).to(torch.uint8)
    dest = torch.where(sm, rank, s)[:, None, :].expand(w, n, s)
    xc = torch.zeros((w, n, s + 1), dtype=torch.uint8, device=dev)
    xc.scatter_(-1, dest, xb)

    in_tile = (f >= 0) & (f < s)
    col = f.clamp(0, max(s - 1, 0))[:, None, None].expand(w, n, 1)
    call = (torch.gather(g, -1, col)[..., 0] == 1) & in_tile[:, None]
    carriers = torch.stack([mem & ~call, mem & call], dim=1)     # [W, 2, N]
    carr = carriers.sum(-1, dtype=torch.int32)
    upper = torch.ones((n, n), dtype=torch.bool, device=dev).triu(1)
    same = ((carriers[:, :, :, None] & carriers[:, :, None, :]).any(1)
            & upper)
    carr_i = carriers.to(torch.int64)

    sums = torch.zeros((w, 2, 2), dtype=torch.int64, device=dev)
    for d, sign in enumerate((-1, 1)):
        # right: ranks fi+1 .. n_act-1; left: ranks fi-1 .. 0
        alive = same.clone()
        for t in range(1, s + 1):
            r = fi + sign * t
            ok = (r < n_act) & (r >= 0)
            if not bool(ok.any()):
                break
            idx = r.clamp(0, s)[:, None, None].expand(w, n, 1)
            x = torch.gather(xc, -1, idx)[..., 0]                # [W, N]
            alive &= x[:, :, None] == x[:, None, :]
            per_row = (alive & ok[:, None, None]).sum(-1, dtype=torch.int64)
            sums[:, d] += (carr_i * per_row[:, None, :]).sum(-1)
    return sums.reshape(*lead, 2, 2), carr.reshape(*lead, 2)


def _ehh_area_cuda(geno, member, site_mask, focal):
    from impop_tpu_torch.ops._build import check, load_library, u8_mask

    dev = geno.device
    lead = tuple(geno.shape[:-2])
    n, s = geno.shape[-2:]
    if geno.dtype != torch.int8:
        raise ValueError(f"ehh_area: geno must be int8, got {geno.dtype}")
    if n == 0 or s == 0:
        raise ValueError(f"ehh_area: empty tile N={n}, S={s}")
    for name, t in (("member", member), ("site_mask", site_mask),
                    ("focal", focal)):
        if t.device != dev:
            raise ValueError(f"ehh_area: {name} on {t.device}, geno on {dev}")
    if tuple(focal.shape) != lead or focal.dtype not in (torch.int32,
                                                          torch.int64):
        raise ValueError(f"ehh_area: focal must be int32/int64 of shape "
                         f"{lead}, got {focal.dtype} {tuple(focal.shape)}")
    w = math.prod(lead)
    mem = u8_mask(member, "ehh_area", "member", lead + (n,))
    smk = u8_mask(site_mask, "ehh_area", "site_mask", lead + (s,))
    foc = focal.to(torch.int32).contiguous()
    genc = geno.contiguous()
    sums = torch.zeros((w, 2, 2), dtype=torch.int64, device=dev)  # atomics
    carr = torch.empty((w, 2), dtype=torch.int32, device=dev)
    if w > 0:
        xc = torch.empty((w, n, (s + 63) // 64), dtype=torch.int64,
                         device=dev)
        meta = torch.empty((w, 2), dtype=torch.int32, device=dev)
        lists = torch.empty((w, 2, n), dtype=torch.int32, device=dev)
        lib = load_library()
        with on_device(dev):   # the launch goes to the current device
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.impop_ehh_area(genc.data_ptr(), mem.data_ptr(),
                                     smk.data_ptr(), foc.data_ptr(), w, n, s,
                                     xc.data_ptr(), meta.data_ptr(),
                                     lists.data_ptr(), sums.data_ptr(),
                                     carr.data_ptr(), stream)
        check(lib, err, "ehh_pack_kernel / ehh_pairs_kernel")
        ehh_area.launches += 1
    return sums.reshape(*lead, 2, 2), carr.reshape(*lead, 2)


def ehh_area(geno: torch.Tensor, member: torch.Tensor,
             site_mask: torch.Tensor, focal: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """EHH step sums and carrier counts of a batch of windows.

    Args:
      geno:      [..., N, S] int8 calls (1 alt; anything else is allele 0)
      member:    [..., N] bool;  site_mask: [..., S] bool
      focal:     [...] int focal column (raw, uncompacted index)
    Returns (sums [..., 2, 2] int64 indexed [direction (left, right),
    allele], carriers [..., 2] int32), alleles (0, 1).
    """
    if geno.device.type == "cpu":
        return ehh_area_plain(geno, member, site_mask, focal)
    if geno.device.type == "cuda":
        return _ehh_area_cuda(geno, member, site_mask, focal)
    raise ValueError(f"ehh_area: unsupported device {geno.device}")


ehh_area.launches = 0
