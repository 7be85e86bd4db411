"""Greedy seeds and group ids for P masks of a window (port of
``impop_tpu.ops.seedpeel.seed_peel_pallas`` and of the gid it feeds,
``impop_tpu.stats.grouping._gid_from_seeds``).

seed(i) ⟺ i is in the mask and no seed j < i of the same mask links to i,
with link(j, i) = sim > threshold ∧ present ∧ both members (strict >);
gid(i) = i for a seed, the smallest seed linked to i for any other mask
member, N outside the mask.

- :func:`seed_peel_plain`: the seeds by the chunked frontier peel of
  ``impop_tpu.stats.grouping.greedy_group_panels`` in PyTorch.
- :func:`seed_gid_plain`: the seeds and their gid (by an argmax over the
  linked seeds), the plain version of the kernel.
- :func:`seed_peel`: the wrapper, (seeds, gid).  CPU tensors take the plain
  version; CUDA tensors launch ``csrc/windowstat.cu``'s
  ``seed_link_kernel`` (the link words, one warp per row, byte-bound) and
  ``seed_peel_kernel`` (one warp walks one mask from the link words in
  shared memory and writes seeds and gid in the same walk; bound by the
  longest mask's chain of seeds), or raise.
"""
from __future__ import annotations

import math

import torch

from impop_tpu_torch.device import on_device

__all__ = ["seed_peel", "seed_peel_plain", "seed_gid_plain", "link_matrix"]

# bound on the [..., P, N, N] candidate mask of _gid_from_seeds per chunk
_GID_CHUNK_ELEMS = 1 << 27
# the walk keeps at most 32 words of undecided members in each lane
_MAX_N = 32 * 32 * 32


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


def _gid_from_seeds(seed, elink, pm, n_cap):
    """gid[..., p, i] = min{ seed j < i : elink[j, i] }; i if seed; N
    outside the mask.  The first True along j of seed ∧ elink is the
    smallest linked seed (argmax returns the first maximum)."""
    lead = seed.shape[:-2]
    p_count = seed.shape[-2]
    b = math.prod(lead)
    seed_b = seed.reshape(b, p_count, n_cap)
    elink_b = elink.expand(*lead, n_cap, n_cap).reshape(b, n_cap, n_cap)
    min_seed = torch.empty((b, p_count, n_cap), dtype=torch.int64,
                           device=seed.device)
    step = max(1, _GID_CHUNK_ELEMS // max(1, p_count * n_cap * n_cap))
    for lo in range(0, b, step):
        cand = seed_b[lo:lo + step, :, :, None] & elink_b[lo:lo + step, None]
        first = cand.to(torch.uint8).argmax(dim=-2)
        min_seed[lo:lo + step] = torch.where(cand.any(dim=-2), first, n_cap)
    order = torch.arange(n_cap, device=seed.device)
    gid = torch.where(seed, order, min_seed.reshape(*lead, p_count, n_cap))
    return torch.where(pm, gid, n_cap).to(torch.int32)


def seed_gid_plain(sim, present, member, pmasks, threshold
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(seeds [..., P, N] bool, gid [..., P, N] int32), any device, no
    kernel."""
    seeds = seed_peel_plain(sim, present, member, pmasks, threshold)
    elink = link_matrix(sim, present, member, threshold)
    pm = pmasks & member[..., None, :]
    return seeds, _gid_from_seeds(seeds, elink, pm, sim.shape[-1])


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it when its data is not 16-byte aligned (the
    kernels read 16 bytes at a time)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _seed_peel_cuda(sim, present, member, pmasks, threshold):
    from impop_tpu_torch.ops._build import check, load_library, u8_mask

    what = "seed_peel"
    lead = tuple(sim.shape[:-2])
    n_cap = sim.shape[-1]
    p_count = pmasks.shape[-2]
    if n_cap % 32 or n_cap == 0 or n_cap > _MAX_N:
        raise ValueError(f"{what}: N={n_cap} must be a positive multiple of "
                         f"32, at most {_MAX_N}")
    if sim.shape[-2] != n_cap:
        raise ValueError(f"{what}: sim has shape {tuple(sim.shape)}, not "
                         "[..., N, N]")
    dev = sim.device
    for name, t in (("present", present), ("member", member),
                    ("pmasks", pmasks)):
        if t.device != dev:
            raise ValueError(f"{what}: {name} on {t.device}, sim on {dev}")
    b = math.prod(lead)
    simc = _aligned(sim.to(torch.float32).contiguous())
    presc = _aligned(u8_mask(present, what, "present", lead + (n_cap, n_cap)))
    memc = _aligned(u8_mask(member, what, "member", lead + (n_cap,)))
    pmc = _aligned(u8_mask(pmasks, what, "pmasks", lead + (p_count, n_cap)))
    # the walk writes every element of both
    seeds = torch.empty((b, p_count, n_cap), dtype=torch.uint8, device=dev)
    gid = torch.empty((b, p_count, n_cap), dtype=torch.int32, device=dev)
    if b > 0 and p_count > 0:
        link = torch.empty((b, n_cap, n_cap // 32), dtype=torch.int32,
                           device=dev)
        lib = load_library()
        with on_device(dev):   # the launch goes to the current device
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.impop_seed_peel(
                simc.data_ptr(), presc.data_ptr(), memc.data_ptr(),
                pmc.data_ptr(), float(threshold), b, n_cap, p_count,
                link.data_ptr(), seeds.data_ptr(), gid.data_ptr(), stream)
        check(lib, err, "seed_link_kernel / seed_peel_kernel")
        seed_peel.launches += 1
    shape = (*lead, p_count, n_cap)
    return seeds.view(torch.bool).view(shape), gid.view(shape)


def seed_peel(sim: torch.Tensor, present: torch.Tensor, member: torch.Tensor,
              pmasks: torch.Tensor, threshold
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy seeds [..., P, N] bool and group ids [..., P, N] int32 (the
    seed row of each mask member, N elsewhere) for sim/present
    [..., N, N], member [..., N] and pmasks [..., P, N]."""
    if sim.device.type == "cpu":
        return seed_gid_plain(sim, present, member, pmasks, threshold)
    if sim.device.type == "cuda":
        return _seed_peel_cuda(sim, present, member, pmasks, threshold)
    raise ValueError(f"seed_peel: unsupported device {sim.device}")


seed_peel.launches = 0
