"""impop_tpu_torch.ops.panelquad against the JAX package (CPU backend):
``masked_pair_sums_pallas`` in interpret mode and ``masked_pair_sums_xla``.

Tolerance: rtol 1e-5 — the sums carry real (1 - sim) values and group
weights in float32, taken in another order on each side."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from impop_tpu.ops.panelquad import (masked_pair_sums_pallas,
                                     masked_pair_sums_xla)
from impop_tpu.stats.allele import identity_from_alleles as j_identity
from impop_tpu_torch.ops.panelquad import (masked_pair_sums,
                                           masked_pair_sums_plain)

torch.set_num_threads(1)


def operands(seed, n=128, s=128, rd=35, rp=25, weighted=True):
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, 6, size=n)
    base = rng.integers(0, 2, size=(6, s)).astype(np.int8)
    geno = np.where(rng.random((n, s)) < 0.02, 1 - base[cls],
                    base[cls]).astype(np.int8)
    geno[rng.random((n, s)) < 0.05] = -1
    geno[: n // 3, s // 2:] = -1          # partial coverage: absent pairs
    member = np.ones(n, bool)
    member[-11:] = False
    weights = (jnp.asarray(rng.integers(1, 30, size=s).astype(np.float32))
               if weighted else None)
    sim, present = j_identity(jnp.asarray(geno), jnp.asarray(member),
                              jnp.ones(s, bool), jnp.float32(5000.0),
                              site_weights=weights)
    wd = (rng.random((rd, n)) * (rng.random((rd, n)) < 0.4)).astype(
        np.float32)
    wp = (rng.random((rp, n)) < 0.3).astype(np.float32)
    return np.array(sim), np.array(present), wd, wp


def torch_sums(fn, sim, present, wd, wp):
    yd, yp = fn(*(torch.from_numpy(a) for a in (sim, present, wd, wp)))
    return yd.numpy(), yp.numpy()


@pytest.mark.parametrize("seed,weighted,block", [(1, True, 64),
                                                 (2, False, 128)])
def test_masked_pair_sums_matches_pallas_interpret(seed, weighted, block):
    from jax.experimental.pallas import tpu as pltpu

    # the Pallas kernel takes one row count for both stacks
    sim, present, wd, wp = operands(seed, rd=35, rp=35, weighted=weighted)
    with pltpu.force_tpu_interpret_mode():
        yd_j, yp_j = masked_pair_sums_pallas(
            *(jnp.asarray(a) for a in (sim, present, wd, wp)), block=block)
    yd_t, yp_t = torch_sums(masked_pair_sums_plain, sim, present, wd, wp)
    np.testing.assert_allclose(yd_t, np.asarray(yd_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(yp_t, np.asarray(yp_j), rtol=1e-5, atol=1e-6)


def test_masked_pair_sums_matches_xla_and_dispatch():
    """Unequal row counts (Rd != Rp) against the XLA formulation; a leading
    window axis; CPU tensors take the plain version without a launch."""
    ops = [operands(seed) for seed in (3, 4)]
    for sim, present, wd, wp in ops:
        yd_j, yp_j = masked_pair_sums_xla(*(jnp.asarray(a) for a in
                                            (sim, present, wd, wp)))
        yd_t, yp_t = torch_sums(masked_pair_sums_plain, sim, present, wd, wp)
        np.testing.assert_allclose(yd_t, np.asarray(yd_j), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(yp_t, np.asarray(yp_j), rtol=1e-5,
                                   atol=1e-6)
    stacked = [torch.from_numpy(np.stack([o[i] for o in ops]))
               for i in range(4)]
    before = masked_pair_sums.launches
    yd, yp = masked_pair_sums(*stacked)
    assert masked_pair_sums.launches == before
    for k, (sim, present, wd, wp) in enumerate(ops):
        yd_k, yp_k = torch_sums(masked_pair_sums_plain, sim, present, wd, wp)
        np.testing.assert_array_equal(yd[k].numpy(), yd_k)
        np.testing.assert_array_equal(yp[k].numpy(), yp_k)
    with pytest.raises(ValueError, match="unsupported device"):
        masked_pair_sums(*(t.to("meta") for t in stacked))
