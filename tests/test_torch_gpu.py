"""The CUDA kernels against their plain PyTorch versions, on a card.

Marked ``gpu``; each test skips without CUDA.  This file imports nothing
of JAX, so it also runs where JAX is absent:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Tolerances: integer outputs exact (S, n, num_groups, pairs_used2, cnt_*,
seed_risk, seeds); quad, sum_* and gdxy rtol 1e-5 (float32 sums in
another order).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from impop_tpu_torch.ops.seedpeel import seed_peel, seed_peel_plain
from impop_tpu_torch.ops.windowstat import window_stats, window_stats_plain
from impop_tpu_torch.stats.allele import identity_from_alleles
from impop_tpu_torch.stats.panelstats import panel_mask_stack

THR, LEN = 0.999, 5000.0
INT_KEYS = ("n", "num_groups", "pairs_used2", "cnt_aa", "cnt_bb", "cnt_ab",
            "s", "seed_risk")
FLOAT_KEYS = ("quad", "sum_aa", "sum_bb", "sum_ab", "gdxy")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from impop_tpu_torch.device import resolve_device

    return resolve_device("cuda")


def batch(seed, w, n, s, p, disjoint, partial):
    rng = np.random.default_rng(seed)
    n_mem = n - 13
    geno = np.full((w, n, s), -1, np.int8)
    for wi in range(w):
        cls = rng.integers(0, 6, size=n_mem)
        base = rng.integers(0, 2, size=(6, s)).astype(np.int8)
        g = base[cls]
        geno[wi, :n_mem] = np.where(rng.random((n_mem, s)) < 0.003, 1 - g, g)
    geno[:, :n_mem][rng.random((w, n_mem, s)) < 0.03] = -1
    if partial:
        geno[:, : n_mem // 2, s // 2:] = -1
        geno[:, n_mem // 2:, : s // 2] = -1
    member = np.zeros((w, n), bool)
    member[:, :n_mem] = True
    smask = np.ones((w, s), bool)
    smask[:, -7:] = False
    if disjoint:
        pmasks = np.zeros((w, p, n), bool)
        edges = np.linspace(0, n_mem, p + 1).astype(int)
        for i in range(p):
            pmasks[:, i, edges[i]:edges[i + 1]] = True
    else:
        pmasks = rng.random((w, p, n)) < 0.5
    return geno, member, smask, pmasks


@pytest.mark.gpu
@pytest.mark.parametrize("disjoint,partial,n,s,p", [
    (True, False, 512, 128, 5), (False, False, 256, 128, 4),
    (True, True, 128, 128, 2), (True, False, 512, 4096, 5),
    (True, False, 64, 128, 1)])
def test_window_stats_kernel_matches_plain(cuda_device, disjoint, partial,
                                           n, s, p):
    geno, member, smask, pmasks = batch(41, 6, n, s, p, disjoint, partial)
    pairs = [(i, j) for i in range(p) for j in range(i + 1, p)] or [(0, 0)]
    pa, pb = tuple(a for a, _ in pairs), tuple(b for _, b in pairs)
    disjoint = disjoint and p > 1
    g, m, sm, pm = (torch.from_numpy(a).to(cuda_device)
                    for a in (geno, member, smask, pmasks))
    stack, ma, mb = panel_mask_stack(pm, m, pa, pb, disjoint)
    length = torch.full((6,), LEN, device=cuda_device)
    args = (g, m, sm, stack, ma, mb, THR, length, pa, pb, disjoint)
    before = window_stats.launches
    got = window_stats(*args)
    torch.cuda.synchronize()
    assert window_stats.launches == before + 1
    want = window_stats_plain(*args)
    for k in INT_KEYS:
        assert torch.equal(got[k], want[k]), k
    for k in FLOAT_KEYS:
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   msg=k)
    if partial:
        assert bool((got["seed_risk"] == 1).all())


@pytest.mark.gpu
def test_seed_peel_kernel_matches_plain(cuda_device):
    geno, member, smask, pmasks = batch(43, 3, 256, 128, 6, False, False)
    g, m, sm, pm = (torch.from_numpy(a).to(cuda_device)
                    for a in (geno, member, smask, pmasks))
    sim, present = identity_from_alleles(
        g, m, sm, torch.full((3,), LEN, device=cuda_device))
    before = seed_peel.launches
    got = seed_peel(sim, present, m, pm, THR)
    torch.cuda.synchronize()
    assert seed_peel.launches == before + 1
    assert torch.equal(got, seed_peel_plain(sim, present, m, pm, THR))


@pytest.mark.gpu
def test_wrappers_raise_on_bad_input(cuda_device):
    geno, member, smask, pmasks = batch(44, 1, 128, 128, 2, True, False)
    g, m, sm, pm = (torch.from_numpy(a).to(cuda_device)
                    for a in (geno, member, smask, pmasks))
    stack, ma, mb = panel_mask_stack(pm, m, (0,), (1,), True)
    length = torch.full((1,), LEN, device=cuda_device)
    with pytest.raises(ValueError, match="int8"):
        window_stats(g.to(torch.int16), m, sm, stack, ma, mb, THR, length,
                     (0,), (1,), True)
    with pytest.raises(ValueError, match="on cpu"):
        window_stats(g, m.cpu(), sm, stack, ma, mb, THR, length, (0,), (1,),
                     True)
