"""impop_tpu_torch.ops.idgroup and ``fused_window_stats(return_matrices=
True)`` against the JAX package on the CPU backend.

- ``identity_group_plain`` against ``identity_group_pallas`` in interpret
  mode at the shapes of tests/test_ops.py: sim, present, gid and S equal.
- A numpy twin of the CUDA kernel's algorithm (32-row packing, 32 x 32
  pair blocks with their mirrors, the walk on link words) against the
  same interpret run and the plain version: equal.
- ``fused_window_stats`` returns the JAX 4-tuple; with matrices, sim and
  present are equal to JAX's and S exact; PanelStats holds integers exact,
  π and diversities rtol 1e-5, Fst atol 2e-3 (tests/test_torch_panelstats
  tolerances); ``fused_panel_stats(gid=...)`` equals the grouping pass.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from impop_tpu.ops.idgroup import identity_group_pallas
from impop_tpu.stats import panelstats as jps
from impop_tpu_torch.ops.idgroup import identity_group, identity_group_plain
from impop_tpu_torch.stats import panelstats as tps
from test_torch_grouping import walk_link_words
from test_torch_panelquad import pack_words
from test_torch_panelstats import assert_panelstats

torch.set_num_threads(1)
THR, LEN = 0.9995, 5000.0
PAIR_A, PAIR_B = (0, 0, 1, 2), (1, 2, 3, 3)


def window(seed, n=256, s=128, r=7, overlap=True):
    """tests/test_ops.py's identity_group case: class-structured rows,
    missing calls, padding rows and sites, random masks."""
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
    if overlap:
        pmasks = rng.random((r, n)) < 0.6
    else:
        pmasks = np.zeros((r, n), bool)
        edges = np.linspace(0, n - 13, r + 1).astype(int)
        for i in range(r):
            pmasks[i, edges[i]:edges[i + 1]] = True
    return geno, member, smask, pmasks


def t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def pick(res, k):
    """Window k of a batched PanelStats (nested named tuples)."""
    return type(res)(*(pick(f, k) if isinstance(f, tuple) else f[k]
                       for f in res))


@pytest.mark.parametrize("seed", [0, 1])
def test_identity_group_plain_matches_pallas_interpret(seed):
    geno, member, smask, pmasks = window(seed)
    with pltpu.force_tpu_interpret_mode():
        sim_j, pres_j, gid_j, s_j = identity_group_pallas(
            jnp.asarray(geno), jnp.asarray(member), jnp.asarray(smask),
            jnp.asarray(pmasks), jnp.float32(THR), jnp.float32(LEN),
            block=128)
    sim, pres, gid, s_count = identity_group_plain(
        *t(geno, member, smask, pmasks), THR, torch.tensor(LEN))
    np.testing.assert_array_equal(pres.numpy(), np.asarray(pres_j))
    np.testing.assert_array_equal(sim.numpy(), np.asarray(sim_j))
    np.testing.assert_array_equal(gid.numpy(), np.asarray(gid_j))
    assert s_count.dtype == torch.float32
    assert float(s_count) == float(s_j)


def test_identity_group_batched_and_dispatch():
    """A leading window axis equals per-window calls; CPU tensors take the
    plain version without a launch; other devices raise."""
    wins = [window(10 + k, n=96, s=64, r=3) for k in range(3)]
    geno, member, smask, pmasks = (
        torch.from_numpy(np.stack([w[i] for w in wins])) for i in range(4))
    length = torch.tensor([LEN, 1.0, 80_000.0])
    before = identity_group.launches
    out = identity_group(geno, member, smask, pmasks, THR, length)
    assert identity_group.launches == before
    for k in range(3):
        one = identity_group_plain(geno[k], member[k], smask[k], pmasks[k],
                                   THR, length[k])
        for a, b in zip(out, one):
            assert torch.equal(a[k], b)
    with pytest.raises(ValueError, match="unsupported device"):
        identity_group(geno.to("meta"), member, smask, pmasks, THR, length)


@pytest.mark.parametrize("disjoint", [True, False])
def test_fused_window_stats_matrices_match_jax(disjoint):
    """The JAX 4-tuple: (sim, present, S f32, PanelStats)."""
    geno, member, smask, pmasks = window(5, n=128, s=128, r=4,
                                         overlap=not disjoint)
    want = jps.fused_window_stats(
        jnp.asarray(geno), jnp.asarray(member), jnp.asarray(smask),
        jnp.float32(LEN), jnp.asarray(pmasks), jnp.asarray(PAIR_A),
        jnp.asarray(PAIR_B), THR, pairs_disjoint=disjoint)
    got = tps.fused_window_stats(*t(geno, member, smask),
                                 torch.tensor(LEN), torch.from_numpy(pmasks),
                                 PAIR_A, PAIR_B, THR, disjoint)
    assert len(got) == len(want) == 4
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[2].dtype == torch.float32
    assert float(got[2]) == float(want[2])
    assert_panelstats(got[3], want[3])


def test_fused_window_stats_without_matrices():
    """``return_matrices=False`` runs the window program: no matrices, the
    same S and the same statistics as with them."""
    wins = [window(20 + k, n=128, s=128, r=4, overlap=False)
            for k in range(2)]
    geno, member, smask, pmasks = (
        torch.from_numpy(np.stack([w[i] for w in wins])) for i in range(4))
    length = torch.tensor([LEN, 2000.0])
    sim, pres, s_w, res_w = tps.fused_window_stats(
        geno, member, smask, length, pmasks, PAIR_A, PAIR_B, THR, True,
        return_matrices=False)
    assert sim is None and pres is None
    _, _, s_m, res_m = tps.fused_window_stats(
        geno, member, smask, length, pmasks, PAIR_A, PAIR_B, THR, True)
    assert torch.equal(s_w, s_m)
    for k in range(2):
        want = jps.fused_window_stats(
            *(jnp.asarray(w) for w in wins[k][:3]), jnp.float32(length[k]),
            jnp.asarray(wins[k][3]), jnp.asarray(PAIR_A),
            jnp.asarray(PAIR_B), THR, pairs_disjoint=True,
            return_matrices=False)
        assert float(s_w[k]) == float(want[2])
        assert_panelstats(pick(res_w, k), want[3])
        assert_panelstats(pick(res_w, k), pick(res_m, k))


def test_fused_panel_stats_given_gid_matches_jax():
    """``gid=`` skips the grouping pass: the statistics equal those of the
    pass itself and JAX's with the same gid."""
    geno, member, smask, pmasks = window(9, n=128, s=128, r=4)
    sim, pres = (x.numpy() for x in identity_group_plain(
        *t(geno, member, smask, pmasks), THR, torch.tensor(LEN))[:2])
    stack, _, _ = tps.panel_mask_stack(torch.from_numpy(pmasks),
                                       torch.from_numpy(member), PAIR_A,
                                       PAIR_B, False)
    gid = identity_group_plain(*t(geno, member, smask), stack, THR,
                               torch.tensor(LEN))[2]
    args = (*t(sim, pres, member, pmasks), PAIR_A, PAIR_B, THR, False)
    with_gid = tps.fused_panel_stats(*args, gid=gid)
    assert_panelstats(with_gid, jps.fused_panel_stats(
        jnp.asarray(sim), jnp.asarray(pres), jnp.asarray(member),
        jnp.asarray(pmasks), jnp.asarray(PAIR_A), jnp.asarray(PAIR_B), THR,
        pairs_disjoint=False, gid=jnp.asarray(gid.numpy())))
    plain = tps.fused_panel_stats(*args)
    for a, b in zip(with_gid, plain):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)


def emulate_identity_group(geno, member, smask, pmasks, thr, length):
    """numpy twin of ``csrc/idgroup.cu`` on one window.

    pack: rows in blocks of 32, each bit-packed into 32-site words of alt
    and valid bits, the column bitmaps of valid alt / valid ref calls OR-ed
    over the blocks (S: columns in both).  pairs: each 32 x 32 block on or
    above the diagonal computes diff = popc(v_i & v_j & (a_i ^ a_j)),
    present, sim = 1 - diff / max(length, 1) in f32 and link = present &
    j > i & sim > thr; it writes its tile and the mirror, and the link words
    of its rows (the mirror's words are 0).  walk: the seed peel's walk on
    the link words.  Returns (sim, present, gid, S)."""
    n, s = geno.shape
    nw = n // 32
    f32 = np.float32
    valid = (geno >= 0) & smask[None, :] & member[:, None]
    alt = valid & (geno > 0)
    aw, vw = np.zeros((n, s // 32), np.uint64), np.zeros((n, s // 32),
                                                        np.uint64)
    col_alt = np.zeros(s // 32, np.uint64)
    col_ref = np.zeros(s // 32, np.uint64)
    for i_lo in range(0, n, 32):
        rows = slice(i_lo, i_lo + 32)
        aw[rows], vw[rows] = pack_words(alt[rows]), pack_words(valid[rows])
        col_alt |= np.bitwise_or.reduce(aw[rows], axis=0)
        col_ref |= np.bitwise_or.reduce(vw[rows] & ~aw[rows], axis=0)
    s_count = float(np.bitwise_count(col_alt & col_ref).sum())

    length = f32(max(float(length), 1.0))
    sim = np.full((n, n), np.nan, f32)
    present = np.zeros((n, n), bool)
    link = np.zeros((n, nw), np.uint64)
    for iw in range(nw):
        for jw in range(iw, nw):
            ri, rj = slice(32 * iw, 32 * iw + 32), slice(32 * jw, 32 * jw + 32)
            both = vw[ri, None, :] & vw[None, rj, :]
            dn = np.bitwise_count(both & (aw[ri, None, :] ^ aw[None, rj, :]))
            dn = dn.sum(axis=-1)
            pres = (both != 0).any(axis=-1) & member[ri, None] & member[None, rj]
            ii, jj = np.meshgrid(np.arange(32 * iw, 32 * iw + 32),
                                 np.arange(32 * jw, 32 * jw + 32),
                                 indexing="ij")
            diag = ii == jj
            pres = np.where(diag, member[ri, None], pres)
            tile = np.where(pres, f32(1) - dn.astype(f32) / length, f32(0))
            tile = np.where(diag & pres, f32(1), tile).astype(f32)
            lk = pres & (jj > ii) & (tile > f32(thr))
            sim[ri, rj], present[ri, rj] = tile, pres
            link[ri, jw] = pack_words(lk)[:, 0]
            if jw != iw:   # the mirror; its link words stay 0
                sim[rj, ri], present[rj, ri] = tile.T, pres.T
    assert not np.isnan(sim).any()
    words = [[int(w) for w in row] for row in link]
    gid = walk_link_words(words, pmasks & member[None, :])[1]
    return sim, present, gid, s_count


@pytest.mark.parametrize("seed,overlap", [(40, True), (41, False)])
def test_kernel_twin_matches_pallas_interpret(seed, overlap):
    """The twin against ``identity_group_pallas`` in interpret mode and the
    port's plain version at tests/test_ops.py's shapes: sim, present, gid
    and S equal."""
    geno, member, smask, pmasks = window(seed, overlap=overlap)
    sim, pres, gid, s_count = emulate_identity_group(geno, member, smask,
                                                     pmasks, THR, LEN)
    with pltpu.force_tpu_interpret_mode():
        want = identity_group_pallas(
            jnp.asarray(geno), jnp.asarray(member), jnp.asarray(smask),
            jnp.asarray(pmasks), jnp.float32(THR), jnp.float32(LEN),
            block=128)
    plain = identity_group_plain(*t(geno, member, smask, pmasks), THR,
                                 torch.tensor(LEN))
    for other in ([np.asarray(a) for a in want],
                  [a.numpy() for a in plain]):
        np.testing.assert_array_equal(pres, other[1])
        np.testing.assert_array_equal(sim, other[0])
        np.testing.assert_array_equal(gid, other[2])
        assert s_count == float(other[3])
    assert int((gid < geno.shape[0]).sum()) > 0
