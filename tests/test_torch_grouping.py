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
    group id in the JAX grouping."""
    sim, present, member, pmasks = window(5)
    gid = np.asarray(jg.greedy_group_panels(
        jnp.asarray(sim), jnp.asarray(present), jnp.asarray(member),
        jnp.asarray(pmasks), jnp.float32(THR)))
    want = gid == np.arange(sim.shape[0])[None, :]
    got = seed_peel_plain(*_t(sim, present, member, pmasks), THR)
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper takes the plain version for CPU tensors
    assert torch.equal(seed_peel(*_t(sim, present, member, pmasks), THR),
                       got)


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
