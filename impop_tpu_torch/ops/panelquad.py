"""The masked panel reductions for a batch of windows (port of
``impop_tpu.ops.panelquad.masked_pair_sums_pallas``).

    Yd = Wd @ ((1 - sim) ⊙ mask),   Yp = Wp @ mask,   mask = present ∧ offdiag

- :func:`masked_pair_sums_plain`: the formula in PyTorch (the twin of
  ``masked_pair_sums_xla``).  It is also the reduction inside the plain
  version of the window kernel, which must never reach a kernel.
- :func:`masked_pair_sums`: the wrapper.  CPU tensors take the plain
  version; CUDA tensors launch ``csrc/panelquad.cu``'s
  ``masked_rows_pack_kernel`` (is each row of Wd and Wp 0/1?) and
  ``masked_pair_sums_kernel`` (one block per window, 64 columns and two
  64-row tiles of the stacks; sim / present come in by TMA once per
  block), or raise.  The weighted scan, the matrices-out route and the
  per-statistic drivers call it.

The products run on the tensor cores in exact bf16 pieces (three for a
row with other values than 0 and 1, one for a 0/1 row) with fp32
accumulation (``csrc/rowprod.cuh``), so Yd agrees with the plain version
to float32 rounding, not bit for bit; a 0/1 row of Wp sums exact 0/1
products to integers, so its Yp is exactly equal.
"""
from __future__ import annotations

import math

import torch

from impop_tpu_torch.device import on_device

__all__ = ["masked_pair_sums", "masked_pair_sums_plain"]

# the kernel's TMA views read rows a multiple of 16 elements apart, from
# 16-byte aligned bases
_ROW_ALIGN = 16


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
    ld = -(-n // _ROW_ALIGN) * _ROW_ALIGN
    simc, presc, wdc, wpc = (_tma_rows(t, n, ld) for t in (
        sim, present.contiguous().view(torch.uint8), wd, wp))
    yd = torch.empty(lead + (rd, n), dtype=torch.float32, device=dev)
    yp = torch.empty(lead + (rp, n), dtype=torch.float32, device=dev)
    if w > 0 and n > 0 and rd + rp > 0:
        # scratch: the 0/1 flag of every row of Wd and Wp
        flags = torch.empty((w, rd + rp), dtype=torch.int32, device=dev)
        lib = load_library()
        with on_device(dev):   # the launch goes to the current device
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.impop_masked_pair_sums(
                simc.data_ptr(), presc.data_ptr(), wdc.data_ptr(),
                wpc.data_ptr(), w, n, ld, rd, rp, flags.data_ptr(),
                yd.data_ptr(), yp.data_ptr(), stream)
        check(lib, err, "masked_rows_pack_kernel / masked_pair_sums_kernel")
        masked_pair_sums.launches += 1
    return yd, yp


def _tma_rows(t: torch.Tensor, n: int, ld: int) -> torch.Tensor:
    """t contiguous with its last axis padded from n to ld elements (zeros
    the kernel never reads) and a 16-byte aligned base: a copy only when
    N is not a multiple of 16 or the base is not aligned."""
    t = t.contiguous()
    if ld != n:
        return torch.nn.functional.pad(t, (0, ld - n))
    return t.clone() if t.data_ptr() % 16 else t


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
