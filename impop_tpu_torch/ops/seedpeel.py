"""Greedy seed flags for P masks of a window (port of
``impop_tpu.ops.seedpeel.seed_peel_pallas``).

seed(i) ⟺ i is in the mask and no seed j < i of the same mask links to i,
with link(j, i) = sim > threshold ∧ present ∧ both members (strict >).

- :func:`seed_peel_plain`: the chunked frontier peel of
  ``impop_tpu.stats.grouping.greedy_group_panels`` in PyTorch.
- :func:`seed_peel`: the wrapper.  CPU tensors take the plain version; CUDA
  tensors launch ``seed_peel_kernel`` of ``csrc/windowstat.cu`` (the same
  warp-per-mask sequential walk the window kernel uses), or raise.
"""
from __future__ import annotations

import math

import torch

__all__ = ["seed_peel", "seed_peel_plain", "link_matrix"]


def link_matrix(sim, present, member, threshold) -> torch.Tensor:
    """elink[..., j, i] = j < i ∧ sim > thr ∧ present ∧ both members."""
    n_cap = sim.shape[-1]
    thr = torch.tensor(threshold, dtype=torch.float32, device=sim.device)
    order = torch.arange(n_cap, device=sim.device)
    return ((sim > thr) & present & member[..., :, None]
            & member[..., None, :] & (order[:, None] < order[None, :]))


def seed_peel_plain(sim, present, member, pmasks, threshold,
                    block: int = 64) -> torch.Tensor:
    """Chunked frontier peel: absorption from earlier chunks is one matvec
    against the seeds found so far; in-chunk dependencies resolve by
    peeling rounds, each deciding every row whose earlier in-chunk
    neighbours are decided.  [..., P, N] bool."""
    n_cap = sim.shape[-1]
    block = math.gcd(n_cap, block)
    elink_f = link_matrix(sim, present, member, threshold).to(torch.float32)
    pm = pmasks & member[..., None, :]
    seeds = torch.zeros_like(pm)
    for lo in range(0, n_cap, block):
        hi = lo + block
        seeds_f = (seeds & pm).to(torch.float32)
        absorbed_ext = (seeds_f @ elink_f[..., :, lo:hi]) > 0.5
        in_chunk = elink_f[..., lo:hi, lo:hi]
        pm_c = pm[..., lo:hi]
        decided = ~pm_c
        seed_c = torch.zeros_like(pm_c)
        while bool((pm_c & ~decided).any()):
            undecided = pm_c & ~decided
            blocked = (undecided.to(torch.float32) @ in_chunk) > 0.5
            frontier = undecided & ~blocked
            absorbed = absorbed_ext | (
                (seed_c.to(torch.float32) @ in_chunk) > 0.5)
            seed_c = seed_c | (frontier & ~absorbed)
            # rows absorbed by a known seed decide at once
            decided = decided | frontier | (pm_c & absorbed)
        seeds[..., lo:hi] = seed_c
    return seeds


def _seed_peel_cuda(sim, present, member, pmasks, threshold):
    from impop_tpu_torch.ops._build import check, load_library

    lead = sim.shape[:-2]
    n_cap = sim.shape[-1]
    p_count = pmasks.shape[-2]
    if n_cap % 32 or n_cap == 0:
        raise ValueError(f"seed_peel: N={n_cap} must be a positive "
                         "multiple of 32")
    if pmasks.shape[:-2] != lead or member.shape[:-1] != lead:
        raise ValueError("seed_peel: leading (window) shapes disagree")
    dev = sim.device
    for name, t in (("present", present), ("member", member),
                    ("pmasks", pmasks)):
        if t.device != dev:
            raise ValueError(f"seed_peel: {name} on {t.device}, sim on {dev}")
    b = math.prod(lead)
    simc = sim.to(torch.float32).contiguous().view(b, n_cap, n_cap)
    presc = present.to(torch.uint8).contiguous().view(b, n_cap, n_cap)
    memc = member.to(torch.uint8).contiguous().view(b, n_cap)
    pmc = pmasks.to(torch.uint8).contiguous().view(b, p_count, n_cap)
    seeds = torch.empty((b, p_count, n_cap), dtype=torch.uint8, device=dev)
    if b == 0 or p_count == 0:
        return seeds.zero_().view(*lead, p_count, n_cap).bool()
    link = torch.empty((b, n_cap, n_cap // 32), dtype=torch.int32,
                       device=dev)
    lib = load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.impop_seed_peel(
        simc.data_ptr(), presc.data_ptr(), memc.data_ptr(), pmc.data_ptr(),
        float(threshold), b, n_cap, p_count, link.data_ptr(),
        seeds.data_ptr(), stream)
    check(lib, err, "seed_peel_kernel")
    seed_peel.launches += 1
    return seeds.view(*lead, p_count, n_cap).bool()


def seed_peel(sim: torch.Tensor, present: torch.Tensor, member: torch.Tensor,
              pmasks: torch.Tensor, threshold) -> torch.Tensor:
    """Greedy seed flags [..., P, N] bool for sim/present [..., N, N],
    member [..., N] and pmasks [..., P, N]."""
    if sim.device.type == "cpu":
        return seed_peel_plain(sim, present, member, pmasks, threshold)
    if sim.device.type == "cuda":
        return _seed_peel_cuda(sim, present, member, pmasks, threshold)
    raise ValueError(f"seed_peel: unsupported device {sim.device}")


seed_peel.launches = 0
