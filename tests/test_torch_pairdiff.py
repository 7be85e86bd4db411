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


# ---- what the tensor-core kernels' wrappers compute in Python


@pytest.mark.parametrize("kind", ["random", "integers", "edges"])
def test_split_weights_sum_back_bit_for_bit(kind):
    """Three bf16 pieces (the high halves of the float32 words) sum back to
    w exactly, each piece is a bf16 value, and integer weights give
    non-negative integer pieces."""
    from impop_tpu_torch.ops.pairdiff import split_weights

    rng = np.random.default_rng(5)
    if kind == "random":
        w = rng.standard_normal(4096).astype(np.float32) * np.float32(
            10.0) ** rng.integers(-20, 20, 4096).astype(np.float32)
    elif kind == "integers":
        w = rng.integers(1, 1 << 24, 4096).astype(np.float32)
    else:
        w = np.array([1.0, 100_000.0, (1 << 24) - 1, 257.0, 65_537.0,
                      0.0, 1.5, 3.0e-3, 12_345_678.0], np.float32)
    wt = torch.from_numpy(w)
    pieces = split_weights(wt)
    assert pieces.shape == (3,) + wt.shape and pieces.dtype == torch.float32
    back = (pieces[0] + pieces[1]) + pieces[2]
    assert torch.equal(back.view(torch.int32), wt.view(torch.int32))
    assert torch.equal(pieces.to(torch.bfloat16).to(torch.float32), pieces)
    ints = wt == wt.round()
    if kind != "random":
        assert bool((pieces >= 0).all())
    assert torch.equal(pieces[:, ints], pieces[:, ints].round())


@pytest.mark.parametrize("seed,w_max", [(0, 50), (1, 100_000), (2, 1)])
def test_split_gram_emulation_equals_plain(seed, w_max):
    """The weighted kernel's arithmetic (row operand [a·w_p | c·w_p] per
    piece, column operand [c | a]) equals the plain version exactly for
    integer weights, with an SV column of 100 000 bp."""
    from impop_tpu_torch.ops.pairdiff import (
        pairwise_identity_weighted_split_plain)

    geno, member, smask, weights = tile(seed, 70, 90, w_max=w_max)
    args = [torch.from_numpy(a) for a in (geno, member, smask)]
    wt = torch.from_numpy(weights)
    got = pairwise_identity_weighted_split_plain(*args, 5000.0, wt)
    want = pairwise_identity_weighted_plain(*args, 5000.0, wt)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])


def test_split_gram_emulation_non_integer_weights():
    """Non-integer weights: within float32 rounding of the sums."""
    from impop_tpu_torch.ops.pairdiff import (
        pairwise_identity_weighted_split_plain)

    geno, member, smask, _ = tile(3, 60, 80)
    wt = torch.from_numpy(np.random.default_rng(3).uniform(
        0.0, 50.0, 80).astype(np.float32))
    args = [torch.from_numpy(a) for a in (geno, member, smask)]
    got = pairwise_identity_weighted_split_plain(*args, 5000.0, wt)
    want = pairwise_identity_weighted_plain(*args, 5000.0, wt)
    assert torch.equal(got[1], want[1])
    torch.testing.assert_close(got[0], want[0], rtol=0.0,
                               atol=1e-5 * float(wt.sum()) / 5000.0 + 1e-6)


@pytest.mark.parametrize("w,n,s,kt,sms,splits", [
    (10, 512, 3200, 64, 132, None), (8, 512, 8192, 64, 132, None),
    (64, 512, 2048, 64, 132, None), (3, 37, 37, 64, 132, None),
    (2, 1024, 3120, 64, 132, None), (64, 512, 128, 32, 132, None),
    (1, 200, 1, 32, 132, None), (1, 512, 8192, 64, 132, 5),
    (2, 300, 1000, 64, 132, 4), (4, 129, 700, 32, 16, None),
    (1, 0, 16, 64, 132, None)])
def test_partition_covers_each_cell_once(w, n, s, kt, sms, splits):
    """Every (window, i, j >= i, site) is covered by exactly one block of
    the grid the wrapper launches, every split holds at least one stage,
    and no block reaches past the padded sites."""
    from impop_tpu_torch.ops.pairdiff import (TILE, identity_partition,
                                              tile_pair)

    t, pairs, ks, chunk = identity_partition(w, n, s, kt, sms, splits)
    nk = -(-s // kt)
    assert t == -(-n // TILE) and pairs == t * (t + 1) // 2
    assert 1 <= ks and (ks - 1) * chunk < max(nk, 1) <= ks * chunk
    if splits is not None and nk:
        assert ks <= splits
    seen = {}
    for p in range(pairs):
        ti, tj = tile_pair(p, t)
        assert 0 <= ti <= tj < t
        assert (ti, tj) not in seen
        seen[(ti, tj)] = p
    assert len(seen) == pairs
    cover = np.zeros((n, n), np.int64)
    for ti, tj in seen:
        cover[ti * TILE:(ti + 1) * TILE, tj * TILE:(tj + 1) * TILE] += 1
    upper = np.triu(np.ones((n, n), bool))
    assert (cover[upper] == 1).all()
    sites = np.zeros(max(s, 1), np.int64)
    for split in range(ks):
        k0 = split * chunk
        k1 = min(nk, k0 + chunk)
        assert k1 > k0 or nk == 0
        sites[k0 * kt:min(s, k1 * kt)] += 1
    assert (sites[:s] == 1).all()


def test_partition_fills_the_card():
    """Small batches split their sites; full batches do not."""
    from impop_tpu_torch.ops.pairdiff import identity_partition

    assert identity_partition(8, 512, 8192, 64, 132)[2] > 1
    assert identity_partition(1, 512, 4096, 64, 132)[2] > 1
    assert identity_partition(64, 512, 2048, 64, 132)[2] == 1
    assert identity_partition(320, 512, 128, 32, 132)[2] == 1


@pytest.mark.parametrize("tool,source,variant", [
    ("gram_breakdown", "pairdiff.cu", v) for v in (
        "base", "nodiv", "nomirror", "nostores", "noepi", "nodecode", "nomma",
        "loadsonly")] + [
    ("window_breakdown", "windowstat.cu", v) for v in (
        "base", "novalue", "nostage", "nomask", "nodots")] + [
    ("sums_group_variants", "panelquad.cu", v) for v in (
        "base", "occ3", "stages4", "unroll2", "nofma", "nowords", "nodiv",
        "noload", "nopop")] + [
    ("sums_group_variants", "idgroup.cu", v) for v in (
        "occ3", "orwords", "smemrows", "notab", "nomirror", "nostores")])
def test_breakdown_variants_match_the_kernel_source(tool, source, variant):
    """Each variant of ``bench/gram_breakdown.py``,
    ``bench/window_breakdown.py`` and ``bench/sums_group_variants.py``
    edits text the kernel source still has (the scripts build the variants
    on the card only), and the unit identity kernel issues ``wgmma``."""
    import importlib
    import os

    from impop_tpu_torch.ops._build import _CSRC

    bench = importlib.import_module(f"impop_tpu_torch.bench.{tool}")
    with open(os.path.join(_CSRC, source)) as fh:
        src = fh.read()
    if source == "pairdiff.cu":
        assert "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8" in src
    table = (bench.VARIANTS if tool != "sums_group_variants" else
             bench.SUMS_VARIANTS if source == "panelquad.cu" else
             bench.GROUP_VARIANTS)
    for old, new in table[variant]:
        assert src.count(old) >= 1, old
        assert old != new


def _rn32(x):
    """Round an exact rational to the nearest float32, ties to even."""
    from fractions import Fraction

    c = np.float32(float(x))
    best = None
    for cand in (np.nextafter(c, np.float32(-np.inf)), c,
                 np.nextafter(c, np.float32(np.inf))):
        d = abs(Fraction(float(cand)) - x)
        key = (d, int(np.asarray(cand).view(np.int32)) & 1)
        if best is None or key < best[0]:
            best = (key, cand)
    return best[1]


@pytest.mark.parametrize("length", [1.0, 3.0, 5000.0, 200_000.0, 12_345.0,
                                    2_000_000.0])
def test_epilogue_division_is_ieee(length):
    """The kernels' epilogue divides as q = d·inv, r = fma(−q, len, d),
    q' = fma(r, inv, q) with inv = RN(1 / len) (Markstein): every integer
    d in [0, 3000] and random real d give the IEEE float32 quotient."""
    from fractions import Fraction

    ln = np.float32(length)
    inv = _rn32(1 / Fraction(float(ln)))
    rng = np.random.default_rng(int(length))
    ds = np.concatenate([np.arange(3001, dtype=np.float32),
                         rng.uniform(0, 1e6, 300).astype(np.float32)])
    for d in ds:
        q = _rn32(Fraction(float(d)) * Fraction(float(inv)))
        r = _rn32(Fraction(float(d)) - Fraction(float(q)) * Fraction(float(ln)))
        q2 = _rn32(Fraction(float(r)) * Fraction(float(inv))
                   + Fraction(float(q)))
        assert q2 == d / ln, (d, ln)
