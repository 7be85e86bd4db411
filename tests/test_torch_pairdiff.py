"""impop_tpu_torch.ops.pairdiff (column-mode identity) and the weighted
parts of impop_tpu_torch.stats.allele against the JAX package (CPU
backend): the Pallas kernel in interpret mode and the XLA formulation.

Integer weights keep every weighted difference sum an exact integer below
2^24 in float32, on both sides and in any summation order, and
``1 - diff / max(length, 1)`` is the same IEEE float32 expression, so sim
and present must be equal, not merely close."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from impop_tpu.ops.pairdiff import pairwise_identity_pallas
from impop_tpu.stats.allele import identity_from_alleles as j_identity
from impop_tpu.stats.allele import pairwise_diff as j_pairwise_diff
from impop_tpu_torch.ops.pairdiff import (pairwise_identity_weighted,
                                          pairwise_identity_weighted_plain)
from impop_tpu_torch.stats.allele import identity_from_alleles, pairwise_diff

torch.set_num_threads(1)


def tile(seed, n, s, w_max=50, sv=True):
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, 5, size=n)
    base = rng.integers(0, 2, size=(5, s)).astype(np.int8)
    geno = base[cls]
    geno = np.where(rng.random((n, s)) < 0.02, 1 - geno, geno).astype(np.int8)
    geno[rng.random((n, s)) < 0.05] = -1
    member = np.ones(n, bool)
    member[-7:] = False
    member[2] = True
    geno[2] = -1            # a member with no valid call
    smask = np.ones(s, bool)
    smask[-5:] = False
    weights = rng.integers(1, w_max + 1, size=s).astype(np.float32)
    if sv:
        weights[s // 3] = 100_000.0       # one structural-variant column
    return geno, member, smask, weights


def torch_args(geno, member, smask, length, weights):
    return (torch.from_numpy(geno), torch.from_numpy(member),
            torch.from_numpy(smask), torch.tensor(length),
            torch.from_numpy(weights))


@pytest.mark.parametrize("n,s,length", [(128, 128, 5000.0),
                                        (128, 256, 200_000.0),
                                        (128, 128, 0.0)])
def test_weighted_identity_matches_pallas_interpret(n, s, length):
    from jax.experimental.pallas import tpu as pltpu

    geno, member, smask, weights = tile(n + s, n, s)
    with pltpu.force_tpu_interpret_mode():
        sim_j, pres_j = pairwise_identity_pallas(
            jnp.asarray(geno), jnp.asarray(member), jnp.asarray(smask),
            jnp.float32(length), tile_n=64, tile_s=64,
            site_weights=jnp.asarray(weights))
    sim_t, pres_t = pairwise_identity_weighted_plain(
        *torch_args(geno, member, smask, length, weights))
    np.testing.assert_array_equal(pres_t.numpy(), np.asarray(pres_j))
    np.testing.assert_array_equal(sim_t.numpy(), np.asarray(sim_j))


@pytest.mark.parametrize("seed,w_max", [(1, 1), (2, 50), (3, 5000)])
def test_weighted_identity_matches_jax_xla(seed, w_max):
    geno, member, smask, weights = tile(seed, 96, 160, w_max, sv=w_max > 1)
    sim_j, pres_j = j_identity(jnp.asarray(geno), jnp.asarray(member),
                               jnp.asarray(smask), jnp.float32(5000.0),
                               site_weights=jnp.asarray(weights))
    args = torch_args(geno, member, smask, 5000.0, weights)
    sim_t, pres_t = identity_from_alleles(*args[:4], site_weights=args[4])
    np.testing.assert_array_equal(pres_t.numpy(), np.asarray(pres_j))
    np.testing.assert_array_equal(sim_t.numpy(), np.asarray(sim_j))
    if w_max == 1:
        # unit weights reproduce the unit-weight (z-Gram) identity
        sim_u, pres_u = identity_from_alleles(*args[:4])
        assert torch.equal(sim_u, sim_t) and torch.equal(pres_u, pres_t)


def test_weighted_identity_batched_and_dispatch():
    """A leading window axis equals per-window calls; CPU tensors take the
    plain version without a launch; other devices raise."""
    tiles = [tile(10 + k, 64, 128) for k in range(3)]
    geno, member, smask, weights = (
        torch.from_numpy(np.stack([t[i] for t in tiles])) for i in range(4))
    length = torch.tensor([5000.0, 1.0, 80_000.0])
    before = pairwise_identity_weighted.launches
    sim, pres = pairwise_identity_weighted(geno, member, smask, length,
                                           weights)
    assert pairwise_identity_weighted.launches == before
    for k in range(3):
        s1, p1 = pairwise_identity_weighted_plain(
            geno[k], member[k], smask[k], length[k], weights[k])
        assert torch.equal(sim[k], s1) and torch.equal(pres[k], p1)
    with pytest.raises(ValueError, match="unsupported device"):
        pairwise_identity_weighted(geno.to("meta"), member, smask, length,
                                   weights)


@pytest.mark.parametrize("num_alleles,weighted", [(2, True), (3, False),
                                                  (3, True)])
def test_pairwise_diff_matches_jax(num_alleles, weighted):
    rng = np.random.default_rng(num_alleles)
    n, s = 48, 96
    geno = rng.integers(-1, num_alleles, size=(n, s)).astype(np.int8)
    member = rng.random(n) < 0.9
    smask = rng.random(s) < 0.9
    weights = (rng.integers(1, 40, size=s).astype(np.float32) if weighted
               else None)
    d_j, c_j = j_pairwise_diff(
        jnp.asarray(geno), jnp.asarray(member), jnp.asarray(smask),
        num_alleles, None if weights is None else jnp.asarray(weights))
    d_t, c_t = pairwise_diff(
        torch.from_numpy(geno), torch.from_numpy(member),
        torch.from_numpy(smask), num_alleles,
        None if weights is None else torch.from_numpy(weights))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
