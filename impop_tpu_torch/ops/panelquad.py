"""The masked panel reductions (plain twin of
``impop_tpu.ops.panelquad.masked_pair_sums_xla``).

    Yd = Wd @ ((1 - sim) ⊙ mask),   Yp = Wp @ mask,   mask = present ∧ offdiag

This is the reduction inside the plain version of the window kernel.  The
scan never calls it on the card (the window kernel does this work there),
so the CUDA port of the ``panelquad`` Pallas kernel comes later.
"""
from __future__ import annotations

import torch

__all__ = ["masked_pair_sums"]


def masked_pair_sums(sim: torch.Tensor, present: torch.Tensor,
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
