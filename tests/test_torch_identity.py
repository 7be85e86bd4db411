"""The unit-weight identity of impop_tpu_torch (``ops.pairdiff.
pairwise_identity`` and ``stats.allele.identity_from_alleles``) against the
JAX package on the CPU backend: the Pallas kernels in interpret mode (the
resident schedule, N <= 512; the streamed schedule, N > 512; the int8
kernel) and the JAX CPU path, which also takes allele codes above 1.

Counts are exact integers below 2^24 in float32 on every side and
``1 - diff / max(length, 1)`` is the same IEEE float32 expression, so sim
and present must be equal, not close; S is an integer and equal too."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from impop_tpu.ops.pairdiff import (_pairwise_identity_pallas_i8,
                                    pairwise_identity_pallas)
from impop_tpu.stats.allele import identity_from_alleles as j_identity
from impop_tpu.stats.allele import segregating_sites as j_sites
from impop_tpu_torch.ops.pairdiff import (pairwise_identity,
                                          pairwise_identity_plain)
from impop_tpu_torch.stats.allele import (identity_from_alleles,
                                          segregating_sites)

torch.set_num_threads(1)


def tile(seed, n, s, max_code=1, n_pad=9):
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, 6, size=n)
    base = rng.integers(0, max_code + 1, size=(6, s)).astype(np.int8)
    geno = base[cls]
    flip = rng.random((n, s)) < 0.02
    geno = np.where(flip, rng.integers(0, max_code + 1, size=(n, s)),
                    geno).astype(np.int8)
    geno[rng.random((n, s)) < 0.05] = -1
    member = np.ones(n, bool)
    member[n - n_pad:] = False
    member[4] = True
    geno[4] = -1            # a member with no valid call
    smask = np.ones(s, bool)
    smask[-11:] = False
    return geno, member, smask


def t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def assert_identity_equal(got, want):
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


@pytest.mark.parametrize("n,s,tile_s", [(256, 512, 256),    # row 4
                                        (640, 256, 128)])   # row 5
def test_unit_identity_matches_pallas_interpret(n, s, tile_s):
    geno, member, smask = tile(n, n, s)
    with pltpu.force_tpu_interpret_mode():
        want = pairwise_identity_pallas(
            jnp.asarray(geno), jnp.asarray(member), jnp.asarray(smask),
            jnp.float32(5000.0), tile_n=128, tile_s=tile_s)
    got = pairwise_identity_plain(*t(geno, member, smask),
                                  torch.tensor(5000.0))
    assert_identity_equal(got, want)


def test_unit_identity_matches_int8_kernel_interpret():
    """Row 7: the int8-operand Pallas kernel, run in interpret mode."""
    geno, member, smask = tile(7, 256, 256)
    with pltpu.force_tpu_interpret_mode():
        want = _pairwise_identity_pallas_i8(
            jnp.asarray(geno), jnp.asarray(member), jnp.asarray(smask),
            jnp.float32(20_000.0), tile_n=128, tile_s=128)
    got = pairwise_identity(*t(geno, member, smask), 20_000.0)
    assert_identity_equal(got, want)


@pytest.mark.parametrize("n,s,length", [(64, 2048, 200_000.0),
                                        (96, 128, 5000.0),
                                        (64, 256, 0.0)])
def test_unit_identity_matches_jax_cpu(n, s, length):
    geno, member, smask = tile(n + s, n, s)
    want = j_identity(jnp.asarray(geno), jnp.asarray(member),
                      jnp.asarray(smask), jnp.float32(length))
    got = identity_from_alleles(*t(geno, member, smask),
                                torch.tensor(length))
    assert_identity_equal(got, want)


@pytest.mark.parametrize("max_code", [2, 3])
def test_identity_codes_above_one_match_jax(max_code):
    """Codes 2 and 3 at two-allele calls: the z-Gram with z = 2·max(g, 0)
    − v is the reference's polynomial x(v−x)ᵀ + (v−x)xᵀ (a ±1 z would map
    code 2 to 1 and differ)."""
    geno, member, smask = tile(40 + max_code, 48, 1000, max_code=max_code)
    assert int(geno.max()) == max_code
    want = j_identity(jnp.asarray(geno), jnp.asarray(member),
                      jnp.asarray(smask), jnp.float32(1000.0))
    got = identity_from_alleles(*t(geno, member, smask),
                                torch.tensor(1000.0))
    assert_identity_equal(got, want)


@pytest.mark.parametrize("num_alleles", [3, 4])
def test_identity_num_alleles_matches_jax(num_alleles):
    geno, member, smask = tile(num_alleles, 40, 300,
                               max_code=num_alleles - 1)
    want = j_identity(jnp.asarray(geno), jnp.asarray(member),
                      jnp.asarray(smask), jnp.float32(3000.0), num_alleles)
    got = identity_from_alleles(*t(geno, member, smask),
                                torch.tensor(3000.0), num_alleles)
    assert_identity_equal(got, want)


def test_segregating_sites_counts_columns_without_ref():
    """A column of valid 1s and 2s segregates (max > min), as does one of
    0s and 2s; a column of one code does not."""
    geno = np.array([[1, 0, 2, 1, -1],
                     [2, 2, 2, 1, 0],
                     [1, 0, -1, 1, 0]], np.int8)
    member = np.ones(3, bool)
    smask = np.ones(5, bool)
    want = int(j_sites(jnp.asarray(geno), jnp.asarray(member),
                       jnp.asarray(smask)))
    got = int(segregating_sites(*t(geno, member, smask)))
    assert got == want == 2


@pytest.mark.parametrize("max_code", [1, 3])
def test_segregating_sites_matches_jax(max_code):
    geno, member, smask = tile(11, 64, 512, max_code=max_code)
    want = int(j_sites(jnp.asarray(geno), jnp.asarray(member),
                       jnp.asarray(smask)))
    got = int(segregating_sites(*t(geno, member, smask)))
    assert got == want


def test_unit_identity_batched_and_dispatch():
    """A leading window axis equals per-window calls; CPU tensors take the
    plain version without a launch; other devices raise."""
    tiles = [tile(30 + k, 64, 160) for k in range(3)]
    geno, member, smask = (torch.from_numpy(np.stack([x[i] for x in tiles]))
                           for i in range(3))
    length = torch.tensor([5000.0, 1.0, 80_000.0])
    before = pairwise_identity.launches
    sim, pres = pairwise_identity(geno, member, smask, length)
    assert pairwise_identity.launches == before
    for k in range(3):
        s1, p1 = pairwise_identity_plain(geno[k], member[k], smask[k],
                                         length[k])
        assert torch.equal(sim[k], s1) and torch.equal(pres[k], p1)
    with pytest.raises(ValueError, match="unsupported device"):
        pairwise_identity(geno.to("meta"), member, smask, length)
