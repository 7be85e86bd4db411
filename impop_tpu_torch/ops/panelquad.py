"""The masked panel reductions for a batch of windows (port of
``impop_tpu.ops.panelquad.masked_pair_sums_pallas``).

    Yd = Wd @ ((1 - sim) ⊙ mask),   Yp = Wp @ mask,   mask = present ∧ offdiag

- :func:`masked_pair_sums_plain`: the formula in PyTorch (the twin of
  ``masked_pair_sums_xla``).  It is also the reduction inside the plain
  version of the window kernel, which must never reach a kernel.
- :func:`masked_pair_sums`: the wrapper.  CPU tensors take the plain
  version; CUDA tensors launch ``csrc/panelquad.cu``'s
  ``masked_rows_pack_kernel`` (is each Wp row 0/1?  then bit-pack it) and
  ``masked_pair_sums_kernel`` (one block per window and 64 columns, sim /
  present read once per column tile), or raise.  The weighted scan, the
  matrices-out route and the per-statistic drivers call it.

Yd carries real values ((1 - sim), group weights) in fp32 FMA, so it
agrees with the plain version to float32 rounding, not bit for bit; a 0/1
row of Wp is counted by AND + popcount and its Yp is exactly equal.
"""
from __future__ import annotations

import math

import torch

__all__ = ["masked_pair_sums", "masked_pair_sums_plain"]

# bytes of mask words the kernel keeps in shared memory (kMcolSmemMax)
_MCOL_SMEM_MAX = 32 * 1024


def masked_pair_sums_plain(sim: torch.Tensor, present: torch.Tensor,
                           wd: torch.Tensor, wp: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(wd @ div, wp @ mask) for [..., R, N] row stacks and [..., N, N]
    matrices, in full float32 (``device.resolve_device`` turns TF32 off on
    CUDA: the (1 - sim) values are not exact in a narrower type)."""
    n_cap = sim.shape[-1]
    eye = torch.eye(n_cap, dtype=torch.bool, device=sim.device)
    mask = present & ~eye
    div = torch.where(mask, 1.0 - sim, 0.0)
    return wd @ div, wp @ mask.to(torch.float32)


def _masked_pair_sums_cuda(sim, present, wd, wp):
    from impop_tpu_torch.ops._build import check, load_library

    dev = sim.device
    lead = tuple(sim.shape[:-2])
    n = sim.shape[-1]
    rd, rp = wd.shape[-2], wp.shape[-2]
    if sim.shape[-2] != n or tuple(present.shape) != lead + (n, n):
        raise ValueError("masked_pair_sums: sim and present must be "
                         f"[..., N, N], got {tuple(sim.shape)} and "
                         f"{tuple(present.shape)}")
    if tuple(wd.shape) != lead + (rd, n) or tuple(wp.shape) != lead + (rp, n):
        raise ValueError("masked_pair_sums: wd / wp must be [..., R, N], got "
                         f"{tuple(wd.shape)} and {tuple(wp.shape)}")
    if present.dtype not in (torch.bool, torch.uint8):
        raise ValueError("masked_pair_sums: present must be bool or uint8, "
                         f"got {present.dtype}")
    for name, t in (("sim", sim), ("wd", wd), ("wp", wp)):
        if t.dtype != torch.float32:
            raise ValueError(f"masked_pair_sums: {name} must be float32, got "
                             f"{t.dtype}")
    for name, t in (("present", present), ("wd", wd), ("wp", wp)):
        if t.device != dev:
            raise ValueError(f"masked_pair_sums: {name} on {t.device}, sim "
                             f"on {dev}")
    w = math.prod(lead)
    if w > 65535:
        raise ValueError(f"masked_pair_sums: {w} windows exceed the grid's "
                         "65535")
    simc = sim.contiguous()
    presc = present.contiguous().view(torch.uint8)
    wdc, wpc = wd.contiguous(), wp.contiguous()
    yd = torch.empty(lead + (rd, n), dtype=torch.float32, device=dev)
    yp = torch.empty(lead + (rp, n), dtype=torch.float32, device=dev)
    if w > 0 and n > 0 and rd + rp > 0:
        nwc = -(-n // 32)
        # scratch: the 0/1 flag and packed bits of every Wp row, and each
        # column tile's mask words where they outgrow the kernel's shared
        # memory (N > 4096; the kernel writes all it reads)
        flags = torch.empty((w, rp), dtype=torch.int32, device=dev)
        wbits = torch.empty((w, rp, nwc), dtype=torch.int32, device=dev)
        mcol = None
        if 4 * nwc * 64 > _MCOL_SMEM_MAX:
            mcol = torch.empty((w, -(-n // 64), nwc, 64), dtype=torch.int32,
                               device=dev)
        lib = load_library()
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.impop_masked_pair_sums(
            simc.data_ptr(), presc.data_ptr(), wdc.data_ptr(),
            wpc.data_ptr(), w, n, rd, rp, flags.data_ptr(), wbits.data_ptr(),
            None if mcol is None else mcol.data_ptr(), yd.data_ptr(),
            yp.data_ptr(), stream)
        check(lib, err, "masked_rows_pack_kernel / masked_pair_sums_kernel")
        masked_pair_sums.launches += 1
    return yd, yp


def masked_pair_sums(sim: torch.Tensor, present: torch.Tensor,
                     wd: torch.Tensor, wp: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(Yd [..., Rd, N], Yp [..., Rp, N]) f32 for sim [..., N, N] f32,
    present [..., N, N] bool and row stacks wd / wp [..., R, N] f32."""
    if sim.device.type == "cpu":
        return masked_pair_sums_plain(sim, present, wd, wp)
    if sim.device.type == "cuda":
        return _masked_pair_sums_cuda(sim, present, wd, wp)
    raise ValueError(f"masked_pair_sums: unsupported device {sim.device}")


masked_pair_sums.launches = 0
