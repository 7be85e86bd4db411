"""The whole-window program of the port.

- The plain ``window_stats`` against ``window_stats_pallas`` run in Mosaic
  interpret mode (as tests/test_windowstat.py runs it): disjoint pairs,
  overlapping panels, and the partial-coverage seed_risk case.
- The algorithm of ``csrc/windowstat.cu`` (sequential seed walk, group
  size = 1 + what the seed absorbed, stacked X/Y rows, the host's
  (Y row, X row, column) dot triples) emulated in numpy against the plain
  version, so the kernel's host-side contract is checked without a card.
The CUDA kernel itself is held against the plain version on a card by
tests/test_torch_gpu.py.

Tolerances: integer outputs exact (S, n, num_groups, pairs_used2, cnt_*,
seed_risk); quad, sum_* and gdxy rtol 1e-5 (float32 sums in another
order).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from impop_tpu.ops.windowstat import window_stats_pallas
from impop_tpu.stats.panelstats import panel_mask_stack as j_stack
from impop_tpu_torch.ops.windowstat import (_dot_triples, _pad, out_layout,
                                            window_stats, window_stats_plain)
from impop_tpu_torch.stats.allele import identity_from_alleles
from impop_tpu_torch.stats.panelstats import gdxy_rows, panel_mask_stack

torch.set_num_threads(1)
THR, LEN = 0.9995, 5000.0
INT_KEYS = ("n", "num_groups", "pairs_used2", "cnt_aa", "cnt_bb", "cnt_ab",
            "s", "seed_risk")
FLOAT_KEYS = ("quad", "sum_aa", "sum_bb", "sum_ab", "gdxy")


def window(seed, n=128, s=128, p=4, disjoint=True, partial=False):
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, 6, size=n)
    base = rng.integers(0, 2, size=(6, s)).astype(np.int8)
    geno = base[cls]
    geno = np.where(rng.random((n, s)) < 0.01, 1 - geno, geno).astype(np.int8)
    geno[rng.random((n, s)) < 0.05] = -1
    geno[-13:] = -1
    member = np.ones(n, bool)
    member[-13:] = False
    smask = np.ones(s, bool)
    smask[-9:] = False
    if partial:
        geno[: n // 2, s // 2:] = -1
        geno[n // 2:, : s // 2] = -1
    if disjoint:
        pmasks = np.zeros((p, n), bool)
        edges = np.linspace(0, n - 13, p + 1).astype(int)
        for i in range(p):
            pmasks[i, edges[i]:edges[i + 1]] = True
    else:
        pmasks = rng.random((p, n)) < 0.5
    return geno, member, smask, pmasks


def pairs_for(p):
    if p == 2:
        return (0,), (1,)
    return (0, 0, 1, 2), (1, 2, 3, 3)


def torch_args(geno, member, smask, pmasks, pair_a, pair_b, disjoint):
    g, m, sm, pm = (torch.from_numpy(a) for a in (geno, member, smask,
                                                   pmasks))
    stack, ma, mb = panel_mask_stack(pm, m, pair_a, pair_b, disjoint)
    return (g, m, sm, stack, ma, mb, THR, torch.tensor(LEN), pair_a, pair_b,
            disjoint)


def assert_raw(got, want):
    for k in INT_KEYS:
        np.testing.assert_array_equal(np.asarray(got[k], np.float64),
                                      np.asarray(want[k], np.float64),
                                      err_msg=k)
    for k in FLOAT_KEYS:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(want[k], np.float64),
                                   rtol=1e-5, atol=1e-9, err_msg=k)


@pytest.mark.parametrize("disjoint,partial,p", [
    (True, False, 4), (False, False, 4), (True, True, 2)])
def test_plain_matches_pallas_interpret(disjoint, partial, p):
    geno, member, smask, pmasks = window(29, p=p, disjoint=disjoint,
                                         partial=partial)
    pair_a, pair_b = pairs_for(p)
    stack, ma, mb = j_stack(jnp.asarray(pmasks), jnp.asarray(member),
                            jnp.asarray(pair_a), jnp.asarray(pair_b),
                            disjoint)
    with pltpu.force_tpu_interpret_mode():
        want = window_stats_pallas(
            jnp.asarray(geno), jnp.asarray(member), jnp.asarray(smask),
            stack, ma, mb, jnp.float32(THR), jnp.float32(LEN), pair_a,
            pair_b, disjoint, block=128)
    want = {k: np.asarray(v) for k, v in want.items()}
    args = torch_args(geno, member, smask, pmasks, pair_a, pair_b, disjoint)
    got = {k: v.numpy() for k, v in window_stats(*args).items()}
    assert_raw(got, want)
    if partial:
        assert got["seed_risk"] == 1.0, "fixture must trip seed_risk"


def emulate_kernel(geno, member, smask, stack, ma, mb, length, pair_a,
                   pair_b, disjoint):
    """numpy model of csrc/windowstat.cu for one window -> raw dict."""
    n = geno.shape[0]
    r_count, q = stack.shape[0], ma.shape[0]
    pq = r_count - (0 if disjoint else 2 * q)
    sim, present = identity_from_alleles(
        torch.from_numpy(geno), torch.from_numpy(member),
        torch.from_numpy(smask), torch.tensor(length))
    sim, present = sim.numpy(), present.numpy()
    upper = np.triu(np.ones((n, n), bool), 1)
    link = (sim > np.float32(THR)) & present & upper       # bits j > i
    rd, rp = _pad(r_count + 2 * q), _pad(pq + 2 * q)
    x = np.zeros((rd + rp, n), np.float32)
    x[r_count:r_count + q], x[r_count + q:r_count + 2 * q] = ma, mb
    x[rd + pq:rd + pq + q], x[rd + pq + q:rd + pq + 2 * q] = ma, mb
    lay = out_layout(r_count, pq, q)
    out = np.zeros(lay["n_out"], np.float32)
    seeds_any = np.zeros(n, bool)
    for r in range(r_count):                # phase B: the warp's walk
        todo = stack[r] & member
        n_r = int(todo.sum())
        groups = 0
        for i in range(n):
            if not todo[i]:
                continue
            todo[i] = False
            size = 1 + int((link[i] & todo).sum())
            todo &= ~link[i]
            x[r, i] = np.float32(size) / np.float32(max(n_r, 1))
            if r < pq:
                x[rd + r, i] = 1.0
            seeds_any[i] = True
            groups += 1
        out[lay["n"] + r], out[lay["num_groups"] + r] = n_r, groups
    mask = present & ~np.eye(n, dtype=bool)
    div = np.where(mask, np.float32(1.0) - sim, np.float32(0.0))
    y = np.concatenate([x[:rd] @ div, x[rd:] @ mask.astype(np.float32)])
    ia, ib = gdxy_rows(pair_a, pair_b, pq, disjoint)
    for yr, xr, col in _dot_triples(r_count, pq, q, tuple(ia), tuple(ib)):
        out[col] = y[yr] @ x[xr]
    valid = (geno >= 0) & member[:, None] & smask[None, :]
    out[lay["s"]] = ((valid & (geno > 0)).any(0)
                     & (valid & (geno == 0)).any(0)).sum()
    out[lay["seed_risk"]] = float(
        (seeds_any[:, None] & seeds_any[None, :] & ~present
         & ~np.eye(n, dtype=bool)).any())
    sizes = {"quad": r_count, "n": r_count, "num_groups": r_count,
             "pairs_used2": pq, "sum_aa": q, "cnt_aa": q, "sum_bb": q,
             "cnt_bb": q, "sum_ab": q, "cnt_ab": q, "gdxy": q}
    res = {k: out[lay[k]:lay[k] + m] for k, m in sizes.items()}
    res["s"], res["seed_risk"] = out[lay["s"]], out[lay["seed_risk"]]
    return res


@pytest.mark.parametrize("disjoint,partial,p", [
    (True, False, 4), (False, False, 4), (True, True, 2)])
def test_kernel_algorithm_emulation_matches_plain(disjoint, partial, p):
    geno, member, smask, pmasks = window(31, p=p, disjoint=disjoint,
                                         partial=partial)
    pair_a, pair_b = pairs_for(p)
    args = torch_args(geno, member, smask, pmasks, pair_a, pair_b, disjoint)
    want = {k: v.numpy() for k, v in window_stats_plain(*args).items()}
    stack, ma, mb = (t.numpy() for t in args[3:6])
    got = emulate_kernel(geno, member, smask, stack, ma, mb, LEN, pair_a,
                         pair_b, disjoint)
    assert_raw(got, want)


def test_padding_windows_are_inert():
    """All-zero wire rows decode to no members and length 0: every output
    is finite and zero."""
    geno = torch.full((2, 64, 128), -1, dtype=torch.int8)
    member = torch.zeros((2, 64), dtype=torch.bool)
    smask = torch.zeros((2, 128), dtype=torch.bool)
    pm = torch.zeros((2, 3, 64), dtype=torch.bool)
    stack, ma, mb = panel_mask_stack(pm, member, (0, 0, 1), (1, 2, 2), True)
    out = window_stats(geno, member, smask, stack, ma, mb, THR,
                       torch.zeros(2), (0, 0, 1), (1, 2, 2), True)
    for k, v in out.items():
        assert torch.isfinite(v).all() and not v.any(), k


def test_wrapper_refuses_other_devices():
    geno, member, smask, pmasks = window(3)
    args = list(torch_args(geno, member, smask, pmasks, *pairs_for(4),
                           True))
    args[0] = args[0].to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        window_stats(*args)
