"""impop_tpu_torch.runtime.sitestream against
impop_tpu.runtime.sitestream (JAX on the CPU backend) on the same chunks.

Difference / comparison counts (int32 for unit weights, float32 for
integer weights), S and the spectrum are exact integers on both sides and
must be equal; present equal; sim within 1 ulp (the JAX package's jitted
finalize turns the division by the length into a reciprocal multiply,
tests/test_sitestream.py); π and D rtol 1e-5 (float32 quadratic forms in
another order)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from impop_tpu.runtime.sitestream import \
    SiteStreamAccumulator as JaxAccumulator
from impop_tpu_torch.cli import GenoSimSource
from impop_tpu_torch.runtime.sitestream import SiteStreamAccumulator

torch.set_num_threads(1)
THR = 0.999


def window(seed, n=40, s=1500, max_code=1):
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, max_code + 1, size=(4, s)).astype(np.int8)
    geno = cls[rng.integers(0, 4, size=n)]
    geno = np.where(rng.random((n, s)) < 0.01, 1 - np.minimum(geno, 1),
                    geno).astype(np.int8)
    geno[rng.random((n, s)) < 0.03] = -1
    member = np.ones(n, bool)
    member[-3:] = False
    return geno, member


def stream(acc, geno, chunk, weights=None):
    for lo in range(0, geno.shape[1], chunk):
        acc.update(geno[:, lo:lo + chunk],
                   None if weights is None else weights[lo:lo + chunk])
    return acc


def assert_streams_equal(got, want, jax_acc, torch_acc):
    for a, b in ((torch_acc._diff, jax_acc._state[0]),
                 (torch_acc._comp, jax_acc._state[1])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(got.s) == int(want.s)
    np.testing.assert_array_equal(got.afs.numpy(), np.asarray(want.afs))
    np.testing.assert_array_equal(got.present.numpy(),
                                  np.asarray(want.present))
    np.testing.assert_array_max_ulp(got.sim.numpy(), np.asarray(want.sim),
                                    maxulp=1)
    assert float(got.n) == float(want.n)
    for f in ("pi", "pi_site", "d"):
        np.testing.assert_allclose(float(getattr(got, f)),
                                   float(getattr(want, f)), rtol=1e-5,
                                   err_msg=f)


@pytest.mark.parametrize("chunk,folded", [(128, True), (512, False),
                                          (999, True)])
def test_stream_matches_jax(chunk, folded):
    geno, member = window(chunk)
    n = geno.shape[0]
    j = stream(JaxAccumulator(member, chunk_s=chunk, afs_max_n=n,
                              folded=folded), geno, chunk)
    t = stream(SiteStreamAccumulator(member, chunk_s=chunk, afs_max_n=n,
                                     folded=folded, device="cpu"),
               geno, chunk)
    assert_streams_equal(t.finalize(20_000.0, THR),
                         j.finalize(20_000.0, THR), j, t)


def test_weighted_stream_matches_jax():
    geno, member = window(3)
    weights = np.random.default_rng(3).integers(1, 40, size=geno.shape[1])
    weights = weights.astype(np.float32)
    j = stream(JaxAccumulator(member, chunk_s=256, weighted=True), geno, 256,
               weights)
    t = stream(SiteStreamAccumulator(member, chunk_s=256, weighted=True,
                                     device="cpu"), geno, 256, weights)
    assert t._diff.dtype == torch.float32
    assert_streams_equal(t.finalize(50_000.0, THR),
                         j.finalize(50_000.0, THR), j, t)


def test_stream_subset_and_alleles_match_jax():
    """pi_member narrows π and n, not S; three-allele codes."""
    geno, member = window(4, max_code=2)
    pim = np.random.default_rng(4).random(geno.shape[0]) < 0.5
    j = stream(JaxAccumulator(member, chunk_s=300, num_alleles=3), geno, 300)
    t = stream(SiteStreamAccumulator(member, chunk_s=300, num_alleles=3,
                                     device="cpu"), geno, 300)
    got = t.finalize(8000.0, THR, pi_member=pim)
    assert_streams_equal(got, j.finalize(8000.0, THR, pi_member=pim), j, t)
    assert float(got.n) == float((pim & member).sum())


def test_stream_is_chunk_invariant_and_guards_misuse():
    geno, member = window(5)
    outs = [stream(SiteStreamAccumulator(member, chunk_s=c, device="cpu"),
                   geno, c).finalize(10_000.0, THR) for c in (128, 700)]
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a, b)
    acc = SiteStreamAccumulator(member, device="cpu")
    with pytest.raises(ValueError, match="weighted=True"):
        acc.update(geno, np.ones(geno.shape[1], np.float32))
    with pytest.raises(ValueError, match="chunk must be"):
        acc.update(geno[:-1])
    acc.finalize(1.0, THR)
    with pytest.raises(RuntimeError, match="finalized"):
        acc.update(geno)


@pytest.mark.parametrize("build", [
    lambda: SiteStreamAccumulator(np.ones(8, bool)),
    lambda: GenoSimSource(None)], ids=["SiteStreamAccumulator",
                                       "GenoSimSource"])
def test_library_constructors_default_to_the_card(build, monkeypatch):
    """Left without a device, both take the card, and without CUDA they
    raise instead of landing on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        build()
