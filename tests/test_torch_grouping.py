"""impop_tpu_torch grouping against impop_tpu.stats.grouping (JAX, CPU
backend): seeds and group ids must be bit-identical, sizes and first-pair
winners equal."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from impop_tpu.stats.allele import identity_from_alleles as j_identity
from impop_tpu.stats import grouping as jg
from impop_tpu_torch.ops.seedpeel import seed_peel, seed_peel_plain
from impop_tpu_torch.stats import grouping as tg

torch.set_num_threads(1)
THR = 0.999


def window(seed, n=128, s=128, n_classes=6, frac_missing=0.05,
           partial=False):
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, n_classes, size=n)
    base = rng.integers(0, 2, size=(n_classes, s)).astype(np.int8)
    geno = base[cls]
    geno = np.where(rng.random((n, s)) < 0.004, 1 - geno, geno).astype(np.int8)
    geno[rng.random((n, s)) < frac_missing] = -1
    if partial:
        geno[: n // 2, s // 2:] = -1
        geno[n // 2:, : s // 2] = -1
    member = np.ones(n, bool)
    member[-7:] = False
    geno[-7:] = -1
    smask = np.ones(s, bool)
    sim, present = j_identity(jnp.asarray(geno), jnp.asarray(member),
                              jnp.asarray(smask), jnp.float32(5000.0))
    pmasks = rng.random((5, n)) < 0.45
    pmasks[0] = True
    return np.asarray(sim), np.asarray(present), member, pmasks


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("seed,partial,n_classes", [
    (1, False, 6), (2, True, 6), (3, False, 40), (4, False, 2)])
def test_greedy_group_panels_bit_identical(seed, partial, n_classes):
    sim, present, member, pmasks = window(seed, partial=partial,
                                          n_classes=n_classes)
    want = np.asarray(jg.greedy_group_panels(
        jnp.asarray(sim), jnp.asarray(present), jnp.asarray(member),
        jnp.asarray(pmasks), jnp.float32(THR)))
    got = tg.greedy_group_panels(*_t(sim, present, member, pmasks), THR)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_seed_peel_plain_matches_greedy_group_panels():
    """The plain seed peel's flags are exactly the rows that are their own
    group id in the JAX grouping; the wrapper's gid is the JAX gid."""
    sim, present, member, pmasks = window(5)
    gid = np.asarray(jg.greedy_group_panels(
        jnp.asarray(sim), jnp.asarray(present), jnp.asarray(member),
        jnp.asarray(pmasks), jnp.float32(THR)))
    want = gid == np.arange(sim.shape[0])[None, :]
    got = seed_peel_plain(*_t(sim, present, member, pmasks), THR)
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper takes the plain version for CPU tensors
    seeds, gid_t = seed_peel(*_t(sim, present, member, pmasks), THR)
    assert torch.equal(seeds, got)
    np.testing.assert_array_equal(gid_t.numpy(), gid)


def emulate_seed_peel(sim, present, member, pmasks, thr):
    """numpy twin of ``csrc/windowstat.cu``'s two seed-peel launches on one
    window: S1 packs the link words (bits j > i, both members, present,
    sim > thr in f32), S2 walks each mask (:func:`walk_link_words`).
    Returns (seeds [P, N] bool, gid [P, N] int32)."""
    n = sim.shape[0]
    nw = n // 32
    order = np.arange(n)
    lk = ((sim > np.float32(thr)) & present & member[:, None]
          & member[None, :] & (order[None, :] > order[:, None]))
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)
    link = [[int((lk[i, 32 * k:32 * k + 32] * weights).sum())
             for k in range(nw)] for i in range(n)]
    return walk_link_words(link, pmasks & member[None, :])


def walk_link_words(link, pm):
    """numpy twin of ``seed_peel_kernel`` (the seed peel's and
    identity_group's walk): for each mask, word by word, the lowest
    undecided member (first nonzero word, then its lowest bit) is a seed,
    AND-NOT of its link row (``link[i][k]``, bits j > i) absorbs, and every
    absorbed member's gid is that seed.  Returns (seeds [P, N] bool, gid
    [P, N] int32, N outside the mask)."""
    n = pm.shape[1]
    nw = n // 32
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)
    seeds = np.zeros(pm.shape, bool)
    gid = np.full(pm.shape, n, np.int32)
    for r in range(pm.shape[0]):
        todo = [int((pm[r, 32 * k:32 * k + 32] * weights).sum())
                for k in range(nw)]
        while True:
            live = [k for k in range(nw) if todo[k]]   # the warp min
            if not live:
                break
            kw = live[0]
            bit = (todo[kw] & -todo[kw]).bit_length() - 1
            i = 32 * kw + bit
            todo[kw] &= ~(1 << bit)
            for k in range(kw, nw):
                took = todo[k] & link[i][k]
                while took:
                    low = took & -took
                    gid[r, 32 * k + low.bit_length() - 1] = i
                    took ^= low
                todo[k] &= ~link[i][k]
            seeds[r, i] = True
            gid[r, i] = i
    return seeds, gid


def peel_inputs(seed, n, p):
    """An identity window of n rows with members missing in the middle
    and at the end, and p partial masks (the first the whole member
    set)."""
    rng = np.random.default_rng(seed)
    s = 128
    cls = rng.integers(0, 12, size=n)
    base = rng.integers(0, 2, size=(12, s)).astype(np.int8)
    geno = np.where(rng.random((n, s)) < 0.004, 1 - base[cls], base[cls])
    geno = geno.astype(np.int8)
    geno[rng.random((n, s)) < 0.05] = -1
    member = rng.random(n) < 0.85
    member[-5:] = False
    sim, present = j_identity(jnp.asarray(geno), jnp.asarray(member),
                              jnp.ones(s, bool), jnp.float32(5000.0))
    pmasks = rng.random((p, n)) < 0.6
    pmasks[0] = True
    return np.asarray(sim), np.asarray(present), member, pmasks


@pytest.mark.parametrize("n,p", [(64, 1), (96, 20), (512, 1), (512, 20)])
def test_seed_peel_kernel_emulation_matches_jax(n, p):
    """The kernel's algorithm (numpy twin) against the JAX package: seeds
    equal to ``seed_peel_pallas`` in interpret mode (rows padded to a
    multiple of 128 as non-members: the Pallas kernel takes 128-row
    blocks), gid equal to ``greedy_group_panels``; and both equal to the
    port's wrapper on CPU tensors."""
    from jax.experimental.pallas import tpu as pltpu

    from impop_tpu.ops.seedpeel import seed_peel_pallas

    sim, present, member, pmasks = peel_inputs(n + p, n, p)
    seeds, gid = emulate_seed_peel(sim, present, member, pmasks, THR)
    assert int(seeds.sum(-1).min()) > 1 and gid.max() == n

    want_gid = np.asarray(jg.greedy_group_panels(
        jnp.asarray(sim), jnp.asarray(present), jnp.asarray(member),
        jnp.asarray(pmasks), jnp.float32(THR)))
    np.testing.assert_array_equal(gid, want_gid)
    pad = -n % 128
    padded = [np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, pad)])
              for a in (member, pmasks)]
    sim_p, pres_p = (np.pad(a, ((0, pad), (0, pad))) for a in (sim, present))
    with pltpu.force_tpu_interpret_mode():
        want_seeds = np.asarray(seed_peel_pallas(
            jnp.asarray(sim_p), jnp.asarray(pres_p), jnp.asarray(padded[0]),
            jnp.asarray(padded[1]), jnp.float32(THR),
            block=256 if (n + pad) % 256 == 0 else 128))
    np.testing.assert_array_equal(seeds, want_seeds[:, :n])
    got_seeds, got_gid = seed_peel(*_t(sim, present, member, pmasks), THR)
    np.testing.assert_array_equal(got_seeds.numpy(), seeds)
    np.testing.assert_array_equal(got_gid.numpy(), gid)


@pytest.mark.parametrize("block", [16, 64, 128])
def test_seed_peel_block_independent(block):
    sim, present, member, pmasks = window(6, n_classes=30)
    ref = seed_peel_plain(*_t(sim, present, member, pmasks), THR, block=128)
    got = seed_peel_plain(*_t(sim, present, member, pmasks), THR,
                          block=block)
    assert torch.equal(got, ref)


def test_group_sizes_matches_jax():
    sim, present, member, pmasks = window(7)
    gid = np.asarray(jg.greedy_group_panels(
        jnp.asarray(sim), jnp.asarray(present), jnp.asarray(member),
        jnp.asarray(pmasks), jnp.float32(THR)))
    pm = pmasks & member[None, :]
    for p in range(pm.shape[0]):
        want = np.asarray(jg.group_sizes(jnp.asarray(gid[p]),
                                         jnp.asarray(pm[p])))
        got = tg.group_sizes(*_t(gid[p], pm[p]))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("ordered", [False, True])
def test_first_pair_winner_matches_jax(ordered):
    sim, present, member, pmasks = window(8, partial=True)
    ma = pmasks[1] & member
    mb = (pmasks[2] & member) & ~ma if ordered else ma
    gid = np.asarray(jg.greedy_group_panels(
        jnp.asarray(sim), jnp.asarray(present), jnp.asarray(member),
        jnp.asarray(np.stack([ma, mb])), jnp.float32(THR)))
    want = np.asarray(jg.first_pair_winner(
        jnp.asarray(present), jnp.asarray(ma), jnp.asarray(gid[0]),
        jnp.asarray(gid[1]), member_col=jnp.asarray(mb), ordered=ordered))
    got = tg.first_pair_winner(*_t(present, ma, gid[0], gid[1]),
                               member_col=torch.from_numpy(mb),
                               ordered=ordered)
    np.testing.assert_array_equal(got.numpy(), want)
