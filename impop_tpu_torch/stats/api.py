"""Single-window entry points under the names of
:mod:`impop_tpu.stats.api`, so that a caller switches packages by changing
the import.

There is no jit here: each name is a plain call of the estimator on the
tensors it is given, on their device (the kernels on CUDA tensors, the
plain versions on CPU tensors).  The ``_jit`` suffix is kept only for that
switch.
"""
from __future__ import annotations

import torch

from impop_tpu_torch.stats.diversity import direct_diversity
from impop_tpu_torch.stats.fst import (fst_3pi, hudson_fst_direct,
                                       hudson_fst_grouped)
from impop_tpu_torch.stats.pi import grouped_diversity, pi_grouped
from impop_tpu_torch.stats.tajima import tajimas_d

__all__ = [
    "pi_grouped_jit",
    "grouped_diversity_jit",
    "direct_diversity_jit",
    "hudson_fst_direct_jit",
    "hudson_fst_grouped_jit",
    "tajimas_d_jit",
    "fst_3pi_jit",
]


def pi_grouped_jit(sim, present, member, threshold):
    return pi_grouped(sim, present, member, float(threshold))


def grouped_diversity_jit(sim, present, member, threshold):
    return grouped_diversity(sim, present, member, float(threshold))


def direct_diversity_within_jit(sim, present, mask_a):
    return direct_diversity(sim, present, mask_a)


def direct_diversity_between_jit(sim, present, mask_a, mask_b):
    return direct_diversity(sim, present, mask_a, mask_b)


def direct_diversity_jit(sim, present, mask_a, mask_b=None):
    return direct_diversity(sim, present, mask_a, mask_b)


def hudson_fst_direct_jit(sim, present, mask_a, mask_b):
    return hudson_fst_direct(sim, present, mask_a, mask_b)


def hudson_fst_grouped_jit(sim, present, mask_a, mask_b, threshold):
    return hudson_fst_grouped(sim, present, mask_a, mask_b, float(threshold))


def tajimas_d_jit(n, s, pi):
    return tajimas_d(n, s, pi)


def fst_3pi_jit(pi_a, pi_b, pi_c):
    return fst_3pi(*(torch.as_tensor(x, dtype=torch.float32)
                     for x in (pi_a, pi_b, pi_c)))
