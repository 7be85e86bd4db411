"""impop_tpu_torch.ops.panelquad against the JAX package (CPU backend):
``masked_pair_sums_pallas`` in interpret mode and ``masked_pair_sums_xla``,
for the plain version and for a numpy twin of the CUDA kernel's algorithm.

Tolerance: rtol 1e-5, atol 1e-6 — the sums carry real (1 - sim) values and
group weights in float32, taken in another order on each side; the 0/1
rows of Wp, counted by popcount in the kernel, are exactly equal."""
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


def pack_words(bits):
    """[..., M] bool -> [..., ceil(M / 32)] uint64 words, bit k of word kw
    is entry 32 kw + k (zero past M)."""
    m = bits.shape[-1]
    nw = -(-m // 32)
    padded = np.zeros(bits.shape[:-1] + (32 * nw,), bool)
    padded[..., :m] = bits
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)
    return (padded.reshape(bits.shape[:-1] + (nw, 32)) * weights).sum(
        axis=-1, dtype=np.uint64)


def emulate_masked_pair_sums(sim, present, wd, wp, kc=32):
    """numpy twin of ``csrc/panelquad.cu`` on one window.

    P: each Wp row is checked (every entry 0 or 1?) and bit-packed.  S:
    the i axis in chunks of ``kc`` rows; per chunk the (1 - sim) . mask
    tile, the mask as floats and every column's mask word (bit k is
    mask(i0 + k, j); present is not assumed symmetric) are built once;
    value rows (Wd, and Wp when one of its rows is not 0/1) accumulate in
    fp32 FMA in i order (each product exact in float64, rounded to float32
    with the sum, once per step); 0/1 rows of Wp are AND + popcount of the
    packed row against the column's words.  Returns (yd, yp, binary)."""
    n = sim.shape[0]
    f32 = np.float32
    binary = ((wp == 0) | (wp == 1)).all(axis=1)
    wbits = pack_words(wp == 1)
    values = [wd] + ([wp] if not binary.all() else [])
    x = np.concatenate(values, axis=0).astype(f32)
    acc = np.zeros((x.shape[0], n), f32)
    mcol = np.zeros((n, -(-n // 32)), np.uint64)
    order = np.arange(n)
    for i0 in range(0, n, kc):
        rows = slice(i0, min(i0 + kc, n))
        mask = (present[rows] != 0) & (order[rows, None] != order[None, :])
        div = np.where(mask, f32(1) - sim[rows], f32(0)).astype(f32)
        maskf = mask.astype(f32)
        mcol[:, i0 // 32] = pack_words(mask.T)[:, 0]
        for k in range(div.shape[0]):
            tile = np.concatenate([np.broadcast_to(div[k], (wd.shape[0], n)),
                                   np.broadcast_to(maskf[k], (x.shape[0]
                                                              - wd.shape[0],
                                                              n))])
            prod = x[:, i0 + k, None].astype(np.float64) * tile
            acc = (prod + acc).astype(f32)
    yd = acc[:wd.shape[0]]
    counts = np.bitwise_count(wbits[:, None, :] & mcol[None, :, :]).sum(
        axis=-1).astype(f32)
    yp = counts if binary.all() else np.where(binary[:, None], counts,
                                               acc[wd.shape[0]:])
    return yd, yp, binary


def kernel_operands(seed, n, rd, rp, wp_kind):
    """``operands`` with an asymmetric present (some pairs dropped on one
    side only) and Wp 0/1 (``"01"``) or with one row of other values."""
    sim, present, wd, wp = operands(seed, n=n, s=128, rd=rd, rp=rp)
    rng = np.random.default_rng(seed + 100)
    present = present & ~(np.triu(rng.random((n, n)) < 0.05, 1))
    if wp_kind == "values":
        wp[rp // 2] = rng.random(n).astype(np.float32) * 3.0
    return sim, present, wd, wp


@pytest.mark.parametrize("seed,n,rows,block", [(11, 128, 35, 64),
                                               (12, 256, 2, 128)])
def test_kernel_twin_matches_pallas_interpret(seed, n, rows, block):
    """The twin against ``masked_pair_sums_pallas`` (one row count for both
    stacks) with an asymmetric present: Yp of the 0/1 rows exactly, Yd
    rtol 1e-5."""
    from jax.experimental.pallas import tpu as pltpu

    sim, present, wd, wp = kernel_operands(seed, n, rows, rows, "01")
    assert not np.array_equal(present, present.T)
    yd, yp, binary = emulate_masked_pair_sums(sim, present, wd, wp)
    assert binary.all()
    with pltpu.force_tpu_interpret_mode():
        yd_j, yp_j = masked_pair_sums_pallas(
            *(jnp.asarray(a) for a in (sim, present, wd, wp)), block=block)
    np.testing.assert_array_equal(yp, np.asarray(yp_j))
    np.testing.assert_allclose(yd, np.asarray(yd_j), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed,n,rd,rp,wp_kind", [
    (13, 37, 1, 1, "01"), (14, 96, 2, 2, "01"), (15, 128, 35, 35, "01"),
    (16, 128, 20, 9, "values"), (17, 100, 55, 55, "values")])
def test_kernel_twin_matches_xla(seed, n, rd, rp, wp_kind):
    """The twin against ``masked_pair_sums_xla`` and the port's plain
    version at the drivers' row counts, ragged N, Rd != Rp and a Wp row
    that is not 0/1 (the fp32 branch): 0/1 rows of Yp exactly equal, the
    rest rtol 1e-5."""
    sim, present, wd, wp = kernel_operands(seed, n, rd, rp, wp_kind)
    yd, yp, binary = emulate_masked_pair_sums(sim, present, wd, wp)
    assert binary.all() == (wp_kind == "01")
    yd_j, yp_j = (np.asarray(a) for a in masked_pair_sums_xla(
        *(jnp.asarray(a) for a in (sim, present, wd, wp))))
    yd_t, yp_t = torch_sums(masked_pair_sums, sim, present, wd, wp)
    for want_d, want_p in ((yd_j, yp_j), (yd_t, yp_t)):
        np.testing.assert_array_equal(yp[binary], want_p[binary])
        np.testing.assert_allclose(yp, want_p, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(yd, want_d, rtol=1e-5, atol=1e-6)
