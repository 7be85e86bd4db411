"""The CUDA kernels against their plain PyTorch versions, on a card.

Marked ``gpu``; each test skips without CUDA.  This file imports nothing
of JAX, so it also runs where JAX is absent:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Tolerances: integer outputs exact (S, n, num_groups, pairs_used2, cnt_*,
seed_risk, seeds, gid, EHH step sums and carriers); unit and weighted
sim / present exact (integer counts, integer weights: every sum is exact
in float32); quad, sum_*, gdxy and the masked panel sums rtol 1e-5
(float32 sums in another order), the masked sums' 0/1 rows of Wp exact
(counted by popcount).  The batch estimators of
``parallel/scan`` run on the card against the same call on CPU tensors:
integer fields exact, π and Dxy rtol 1e-5, Fst atol 2e-3.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from impop_tpu_torch.ops.ehhdeath import ehh_area, ehh_area_plain
from impop_tpu_torch.ops.idgroup import identity_group, identity_group_plain
from impop_tpu_torch.ops.pairdiff import (pairwise_identity,
                                          pairwise_identity_plain,
                                          pairwise_identity_weighted,
                                          pairwise_identity_weighted_plain)
from impop_tpu_torch.ops.panelquad import (masked_pair_sums,
                                           masked_pair_sums_plain)
from impop_tpu_torch.ops.seedpeel import seed_gid_plain, seed_peel
from impop_tpu_torch.ops.windowstat import window_stats, window_stats_plain
from impop_tpu_torch.parallel.scan import batch_hudson, batch_pi_panels
from impop_tpu_torch.stats.allele import identity_from_alleles
from impop_tpu_torch.stats.panelstats import (gdxy_rows, panel_mask_stack,
                                              panel_sums)

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
    smask[:, s - min(7, s // 4):] = False   # keeps S = 1 active
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
    (True, False, 64, 128, 1), (False, False, 160, 128, 6),
    (True, False, 96, 256, 3),
    # X stacks of 400 rows: phase C reads its X columns from device memory
    (False, False, 256, 128, 10),
    # 1152 rows: phase B reads the link bits from device memory
    (True, False, 1152, 128, 5)])
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
    peel = seed_peel.launches
    want = window_stats_plain(*args)
    assert seed_peel.launches == peel     # the plain version reaches no kernel
    for k in INT_KEYS:
        assert torch.equal(got[k], want[k]), k
    for k in FLOAT_KEYS:
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   msg=k)
    if partial:
        assert bool((got["seed_risk"] == 1).all())


@pytest.mark.gpu
@pytest.mark.parametrize("w,p,n", [
    (3, 6, 256), (1, 1, 512), (1, 20, 512), (10, 1, 512), (200, 20, 512),
    # 1152 rows: the walk reads the link words from device memory
    (1, 20, 1152), (10, 1, 1152), (200, 1, 1152)])
def test_seed_peel_kernel_matches_plain(cuda_device, w, p, n):
    """Seeds and gid exactly equal to the plain composition."""
    geno, member, smask, pmasks = batch(43, w, n, 128, p, False, False)
    g, m, sm, pm = (torch.from_numpy(a).to(cuda_device)
                    for a in (geno, member, smask, pmasks))
    sim, present = identity_from_alleles(
        g, m, sm, torch.full((w,), LEN, device=cuda_device))
    before = seed_peel.launches
    seeds, gid = seed_peel(sim, present, m, pm, THR)
    torch.cuda.synchronize()
    assert seed_peel.launches == before + 1
    want_seeds, want_gid = seed_gid_plain(sim, present, m, pm, THR)
    assert torch.equal(seeds, want_seeds)
    assert torch.equal(gid, want_gid)
    assert int(seeds.sum(-1).min()) > 1


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
    # 1024 words of rows would put 65 600 pair blocks on grid y
    n_big = 32 * 1024
    ones = torch.ones((1, n_big), dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError, match="at most 32736"):
        identity_group(torch.zeros((1, n_big, 32), dtype=torch.int8,
                                   device=cuda_device), ones, ones[:, :32],
                       ones[:, None], THR, length)


def ehh_inputs(seed, w, n, s, noise=0.003, n_classes=6):
    rng = np.random.default_rng(seed)
    geno = np.zeros((w, n, s), np.int8)
    for wi in range(w):
        base = rng.integers(0, 2, size=(n_classes, s)).astype(np.int8)
        g = base[rng.integers(0, n_classes, size=n)]
        geno[wi] = np.where(rng.random((n, s)) < noise, 1 - g, g)
    geno[rng.random(geno.shape) < noise] = -1  # missing: allele 0
    member = np.zeros((w, n), bool)
    member[:, :n - 46] = True
    smask = rng.random((w, s)) < 0.85
    smask[-1] = False                      # a window with no active site
    focal = np.zeros(w, np.int32)
    for wi in range(w - 1):
        act = np.nonzero(smask[wi])[0]
        focal[wi] = (act[0], act[len(act) // 2], act[-1])[wi % 3]
    return geno, member, smask, focal


@pytest.mark.gpu
@pytest.mark.parametrize("w,n,s,noise,n_classes", [
    (320, 512, 128, 0.003, 6), (16, 512, 1024, 2e-4, 1),
    (5, 96, 200, 0.01, 3), (4, 100, 70, 0.01, 3),
    # 2 x 64 rows of 64 words pass 48 KiB: the pair walk reads the words
    # from device memory
    (3, 512, 4096, 2e-4, 2)])
def test_ehh_area_kernel_matches_plain(cuda_device, w, n, s, noise,
                                       n_classes):
    """Sums and carriers exactly equal to the plain version, with carrier
    lists whose lengths are not multiples of the 64-row tile."""
    arrays = ehh_inputs(47, w, n, s, noise, n_classes)
    args = [torch.from_numpy(a).to(cuda_device) for a in arrays]
    before = ehh_area.launches
    got = ehh_area(*args)
    torch.cuda.synchronize()
    assert ehh_area.launches == before + 1
    want = ehh_area_plain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool((got[1] % 64 != 0).any())
    if s == 1024:
        assert int(got[0].max()) > 1 << 24


def weighted_inputs(seed, w, n, s, weights="int"):
    """Integer weights 1-50 with one 100 000 bp column ("int"), all ones
    ("ones"), or non-integer weights in (0, 50) ("frac")."""
    geno, member, smask, _ = batch(seed, w, n, s, 2, True, False)
    rng = np.random.default_rng(seed)
    if weights == "ones":
        wts = np.ones((w, s), np.float32)
    elif weights == "frac":
        wts = rng.uniform(0.0, 50.0, size=(w, s)).astype(np.float32)
    else:
        wts = rng.integers(1, 51, size=(w, s)).astype(np.float32)
        wts[:, s // 5] = 100_000.0
    return geno, member, smask, wts


@pytest.mark.gpu
@pytest.mark.parametrize("w,n,s,weights,splits", [
    (8, 512, 128, "int", None), (2, 512, 4096, "int", None),
    (3, 100, 77, "int", None), (3, 37, 37, "int", None),
    (2, 37, 1, "int", None), (2, 1024, 3120, "int", None),
    (4, 512, 128, "ones", None), (2, 256, 640, "int", 3),
    (3, 200, 300, "frac", None)])
def test_weighted_identity_kernel_matches_plain(cuda_device, w, n, s,
                                                weights, splits):
    """Integer weights: sim and present exactly equal.  Non-integer
    weights: present equal, sim within 1e-5 of the weight mass per bp
    (the float32 sums run in another order) plus 1e-6."""
    from impop_tpu_torch.ops.pairdiff import _weighted_identity_cuda

    geno, member, smask, wts = weighted_inputs(48, w, n, s, weights)
    args = [torch.from_numpy(a).to(cuda_device)
            for a in (geno, member, smask)]
    length = torch.full((w,), LEN, device=cuda_device)
    weights_t = torch.from_numpy(wts).to(cuda_device)
    before = pairwise_identity_weighted.launches
    if splits is None:
        sim, pres = pairwise_identity_weighted(*args, length, weights_t)
    else:
        sim, pres = _weighted_identity_cuda(*args, length, weights_t,
                                            splits=splits)
    torch.cuda.synchronize()
    assert pairwise_identity_weighted.launches == before + 1
    sim_p, pres_p = pairwise_identity_weighted_plain(*args, length,
                                                     weights_t)
    assert torch.equal(pres, pres_p)
    if weights == "frac":
        atol = 1e-5 * float(wts.sum(axis=1).max()) / LEN + 1e-6
        torch.testing.assert_close(sim, sim_p, rtol=0.0, atol=atol)
    else:
        assert torch.equal(sim, sim_p)


@pytest.mark.gpu
@pytest.mark.parametrize("disjoint", [True, False])
def test_masked_pair_sums_kernel_matches_plain(cuda_device, disjoint):
    """On the row stacks the weighted scan hands to the masked sums."""
    w, n, p = 6, 512, 5
    geno, member, smask, wts = weighted_inputs(49, w, n, 128)
    g, m, sm, wt = (torch.from_numpy(a).to(cuda_device)
                    for a in (geno, member, smask, wts))
    sim, pres = pairwise_identity_weighted(
        g, m, sm, torch.full((w,), LEN, device=cuda_device), wt)
    if disjoint:
        pm = batch(50, w, n, 8, p, True, False)[3]
    else:
        pm = np.random.default_rng(50).random((w, p, n)) < 0.3
    pm = torch.from_numpy(pm).to(cuda_device)
    pairs = [(i, j) for i in range(p) for j in range(i + 1, p)]
    pa, pb = tuple(a for a, _ in pairs), tuple(b for _, b in pairs)
    stack, ma, mb = panel_mask_stack(pm, m, pa, pb, disjoint)
    pq = p + len(pairs)
    ia, ib = gdxy_rows(pa, pb, pq, disjoint)
    seen = {}

    def capture(*xs):
        seen["args"] = xs
        return masked_pair_sums_plain(*xs)

    panel_sums(sim, pres, m, stack, ma, mb, THR, ia, ib, pq,
               pair_sums=capture)
    before = masked_pair_sums.launches
    got = masked_pair_sums(*seen["args"])
    torch.cuda.synchronize()
    assert masked_pair_sums.launches == before + 1
    want = masked_pair_sums_plain(*seen["args"])
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("w,n,rd,rp,wp_kind", [
    (4, 37, 1, 1, "01"), (8, 512, 2, 2, "01"), (6, 512, 35, 35, "01"),
    (3, 512, 55, 55, "01"), (4, 1152, 2, 2, "01"), (2, 1152, 35, 35, "01"),
    (6, 512, 35, 35, "values"), (3, 100, 55, 55, "values"),
    (200, 512, 2, 2, "01"), (200, 512, 1, 1, "values"),
    (3, 256, 0, 3, "01"), (3, 256, 5, 0, "01"),
    # value rows past one block's 128: a second grid layer
    (2, 512, 150, 140, "values"),
    # past N = 4096 the mask words live in the wrapper's scratch
    (2, 4160, 2, 2, "01")])
def test_masked_pair_sums_kernel_shapes(cuda_device, w, n, rd, rp, wp_kind):
    """Any N, the drivers' 1 + 1 and 2 + 2 rows, 35 + 35, 55 + 55, W = 200,
    an asymmetric present, and Wp 0/1 (popcount rows: Yp exactly equal) or
    with a row of other values (the fp32 branch: rtol 1e-5); N = 4160 keeps
    the mask words in device memory."""
    geno, member, smask, _ = batch(56, w, n, 128, 2, True, False)
    rng = np.random.default_rng(56)
    g, m, sm = (torch.from_numpy(a).to(cuda_device)
                for a in (geno, member, smask))
    sim, pres = identity_from_alleles(
        g, m, sm, torch.full((w,), LEN, device=cuda_device))
    drop = torch.from_numpy(np.triu(rng.random((w, n, n)) < 0.05, 1))
    pres = pres & ~drop.to(cuda_device)
    wd = rng.random((w, rd, n)) * (rng.random((w, rd, n)) < 0.4)
    wp = (rng.random((w, rp, n)) < 0.3).astype(np.float32)
    if wp_kind == "values":
        wp[0, rp // 2] = rng.random(n) * 3.0
    wd, wp = (torch.from_numpy(a.astype(np.float32)).to(cuda_device)
              for a in (wd, wp))
    before = masked_pair_sums.launches
    yd, yp = masked_pair_sums(sim, pres, wd, wp)
    torch.cuda.synchronize()
    assert masked_pair_sums.launches == before + 1
    want_d, want_p = masked_pair_sums_plain(sim, pres, wd, wp)
    binary = ((wp == 0) | (wp == 1)).all(dim=-1)
    assert torch.equal(yp[binary], want_p[binary])
    torch.testing.assert_close(yp, want_p, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(yd, want_d, rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("w,n,s,max_code,length,splits", [
    (8, 512, 2048, 1, 200_000.0, None), (2, 1024, 256, 1, LEN, None),
    (3, 100, 77, 3, LEN, None), (2, 64, 96, 1, 0.0, None),
    (3, 37, 37, 1, LEN, None), (2, 37, 1, 1, LEN, None),
    (2, 1024, 3120, 1, LEN, None), (10, 512, 3200, 1, 200_000.0, None),
    (3, 200, 300, 63, LEN, None), (2, 300, 1000, 1, LEN, 4),
    (1, 512, 8192, 1, 200_000.0, 5)])
def test_pairwise_identity_kernel_matches_plain(cuda_device, w, n, s,
                                                max_code, length, splits):
    from impop_tpu_torch.ops.pairdiff import _pairwise_identity_cuda

    geno, member, smask, _ = batch(51, w, n, s, 2, True, False)
    rng = np.random.default_rng(51)
    if max_code > 1:
        geno = np.where(geno > 0, rng.integers(1, max_code + 1,
                                               size=geno.shape),
                        geno).astype(np.int8)
    member[:, 3 % n] = True
    geno[:, 3 % n] = -1              # a member with no valid call
    args = [torch.from_numpy(a).to(cuda_device)
            for a in (geno, member, smask)]
    lens = torch.full((w,), length, device=cuda_device)
    before = pairwise_identity.launches
    if splits is None:
        sim, pres = pairwise_identity(*args, lens)
    else:
        sim, pres = _pairwise_identity_cuda(*args, lens, splits=splits)
    torch.cuda.synchronize()
    assert pairwise_identity.launches == before + 1
    sim_p, pres_p = pairwise_identity_plain(*args, lens)
    assert torch.equal(pres, pres_p)
    assert torch.equal(sim, sim_p)


@pytest.mark.gpu
@pytest.mark.parametrize("w,n,s,p,disjoint", [
    (6, 512, 128, 5, True), (4, 256, 128, 4, False),
    # the matrices-out shape (R = 15), overlapping panels, and 1152 rows
    # (the walk reads the link words from device memory)
    (320, 512, 128, 5, True), (64, 256, 128, 4, False),
    (3, 1152, 128, 5, True),
    # past kBitsMaxSites = 512 sites: present from OR-ed words; pairs of
    # different haplotype classes differ at more than 1024 sites
    (8, 512, 4096, 5, True)])
def test_identity_group_kernel_matches_plain(cuda_device, w, n, s, p,
                                             disjoint):
    geno, member, smask, pmasks = batch(52, w, n, s, p, disjoint, False)
    g, m, sm, pm = (torch.from_numpy(a).to(cuda_device)
                    for a in (geno, member, smask, pmasks))
    pairs = [(i, j) for i in range(p) for j in range(i + 1, p)]
    stack = panel_mask_stack(pm, m, tuple(a for a, _ in pairs),
                             tuple(b for _, b in pairs), disjoint)[0]
    lens = torch.full((w,), LEN, device=cuda_device)
    before = identity_group.launches
    got = identity_group(g, m, sm, stack, THR, lens)
    torch.cuda.synchronize()
    assert identity_group.launches == before + 1
    want = identity_group_plain(g, m, sm, stack, THR, lens)
    for name, a, b in zip(("sim", "present", "gid", "s"), got, want):
        assert torch.equal(a, b), name
    if s > 1024:
        assert bool((got[0][got[1]] < 1.0 - 1024.0 / LEN).any())


def hprc_sims(seed, w, p, disjoint):
    """[512, 512] x w similarity tiles of HPRC-shaped windows (466
    members of 512, 5 kb), computed on the CPU, and their panels."""
    geno, member, smask, pmasks = batch(seed, w, 512, 128, p, disjoint,
                                        False)
    member[:, 466:] = False
    sim, pres = identity_from_alleles(
        *(torch.from_numpy(a) for a in (geno, member, smask)),
        torch.full((w,), LEN))
    return sim, pres, torch.from_numpy(member), torch.from_numpy(pmasks)


@pytest.mark.gpu
@pytest.mark.parametrize("disjoint", [True, False])
def test_batch_pi_panels_on_card_matches_cpu(cuda_device, disjoint):
    """pi_grouped_panels through the seed-peel and masked-sums kernels:
    integer fields exact, pi rtol 1e-5."""
    cpu = hprc_sims(53, 8, 5, disjoint)
    peel, sums = seed_peel.launches, masked_pair_sums.launches
    got = batch_pi_panels(*(a.to(cuda_device) for a in cpu), THR)
    torch.cuda.synchronize()
    assert seed_peel.launches > peel and masked_pair_sums.launches > sums
    want = batch_pi_panels(*cpu, THR)
    for f in ("n", "num_groups", "pairs_used", "pairs_missing"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    torch.testing.assert_close(got.pi.cpu(), want.pi, rtol=1e-5, atol=1e-9)
    assert int(want.num_groups.min()) > 1


@pytest.mark.gpu
@pytest.mark.parametrize("with_grouped", [False, True])
def test_batch_hudson_on_card_matches_cpu(cuda_device, with_grouped):
    """Direct Hudson through the masked-sums kernel, grouped through the
    seed-peel kernel, ten overlapping pairs: pi and Dxy rtol 1e-5, Fst
    atol 2e-3."""
    cpu = hprc_sims(54, 8, 5, False)
    pairs = [(i, k) for i in range(5) for k in range(i + 1, 5)]
    pa, pb = tuple(a for a, _ in pairs), tuple(b for _, b in pairs)
    peel, sums = seed_peel.launches, masked_pair_sums.launches
    got = batch_hudson(*(a.to(cuda_device) for a in cpu), pa, pb, THR,
                       with_grouped=with_grouped)
    torch.cuda.synchronize()
    assert masked_pair_sums.launches > sums
    assert (seed_peel.launches > peel) == with_grouped
    want = batch_hudson(*cpu, pa, pb, THR, with_grouped=with_grouped)
    for res_g, res_w in zip(got, want):
        for f in ("pi_a", "pi_b", "pi_xy", "dxy"):
            torch.testing.assert_close(getattr(res_g, f).cpu(),
                                       getattr(res_w, f), rtol=1e-5,
                                       atol=1e-9, msg=f)
        for f in ("fst", "da"):
            diff = (getattr(res_g, f).cpu() - getattr(res_w, f)).abs()
            assert float(diff.max()) <= 2e-3, f


@pytest.mark.gpu
def test_route_above_the_window_kernel_cap(cuda_device):
    """[2, 512, 65 664]: fused_window_stats(return_matrices=False) composes
    the identity kernel, S and fused_panel_stats (the window kernel is not
    launched) and equals the epilogue on window_stats_plain: integers
    exact, π rtol 1e-5, Fst atol 2e-3."""
    from impop_tpu_torch.stats.panelstats import (_assemble_from_kernel,
                                                  fused_window_stats)

    w, n, s, p = 2, 512, 65_664, 4
    geno, member, smask, pmasks = batch(55, w, n, s, p, True, False)
    pairs = [(i, j) for i in range(p) for j in range(i + 1, p)]
    pa, pb = tuple(a for a, _ in pairs), tuple(b for _, b in pairs)
    g, m, sm, pm = (torch.from_numpy(a).to(cuda_device)
                    for a in (geno, member, smask, pmasks))
    length = torch.full((w,), 2_000_000.0, device=cuda_device)
    before_w, before_i = window_stats.launches, pairwise_identity.launches
    sim, pres, s_count, got = fused_window_stats(
        g, m, sm, length, pm, pa, pb, THR, True, return_matrices=False)
    torch.cuda.synchronize()
    assert sim is None and pres is None
    assert window_stats.launches == before_w
    assert pairwise_identity.launches > before_i
    stack, ma, mb = panel_mask_stack(pm, m, pa, pb, True)
    raw = window_stats_plain(g, m, sm, stack, ma, mb, THR, length, pa, pb,
                             True)
    want = _assemble_from_kernel(raw, p + len(pairs), len(pairs), pa, pb,
                                 True)
    assert torch.equal(s_count, raw["s"])
    for f in ("n", "num_groups", "pairs_used", "pairs_missing",
              "seed_risk"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    torch.testing.assert_close(got.pi, want.pi, rtol=1e-5, atol=1e-9)
    for res_g, res_w in ((got.hudson, want.hudson),
                         (got.hudson_grouped, want.hudson_grouped)):
        torch.testing.assert_close(res_g.dxy, res_w.dxy, rtol=1e-5,
                                   atol=1e-9)
        diff = torch.nan_to_num((res_g.fst - res_w.fst).abs(), nan=0.0)
        assert float(diff.max()) <= 2e-3
