"""impop_tpu_torch.ops.panelquad against the JAX package (CPU backend):
``masked_pair_sums_pallas`` in interpret mode and ``masked_pair_sums_xla``,
for the plain version and for a numpy twin of the CUDA kernel's algorithm;
and the value-row product the masked sums and the window kernel share
(``csrc/rowprod.cuh``): its bf16 split is exact, and its kept piece
products agree with a float64 oracle.

Tolerance: rtol 1e-5, atol 1e-6 — the sums carry real (1 - sim) values and
group weights in float32, taken in another order on each side; the 0/1
rows of Wp, sums of exact 0/1 products in the kernel, are exactly equal."""
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


# the piece products x_p . b_q the kernels keep: p + q <= 2 (0-based)
KEPT = ((0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (2, 0))


def split3(x):
    """The three bf16 pieces of float32 values (``csrc/rowprod.cuh``
    split3): each the bit pattern of what is left cut to its upper 16 bits
    (the top 8 significant bits, rounded toward zero); a non-finite value
    goes whole into the first piece, NaN as the quiet NaN."""
    x = np.asarray(x, np.float32)
    cut = np.uint32(0xFFFF0000)
    with np.errstate(invalid="ignore"):
        p1 = (x.view(np.uint32) & cut).view(np.float32)
        r1 = (x - p1).astype(np.float32)
        p2 = (r1.view(np.uint32) & cut).view(np.float32)
        r2 = (r1 - p2).astype(np.float32)
        p3 = (r2.view(np.uint32) & cut).view(np.float32)
    bad = ~np.isfinite(x)
    if bad.any():
        p1 = np.where(bad, np.where(np.isnan(x), np.float32(np.nan), x), p1)
        p2 = np.where(bad, np.float32(0), p2)
        p3 = np.where(bad, np.float32(0), p3)
    return p1, p2, p3


def piece_products(x, b, kc=32):
    """The kernels' value-row product Y = X . B (``csrc/rowprod.cuh``) in
    numpy: X [R, N] and B [N, M] split into bf16 pieces; per chunk of kc
    i values the six kept products x_p . b_q summed in float64 (each is
    exact: 8 x 8 significant bits) and rounded to float32 (the chunk's
    accumulator), then the chunks added in i order in float32.  A 0/1
    operand's pieces 2 and 3 are zero, so it takes its one product.  (The
    tensor core rounds a chunk's sum toward zero, the model to nearest: the
    same size of error, once a chunk.)"""
    xp = [p.astype(np.float64) for p in split3(x)]
    bp = [p.astype(np.float64) for p in split3(b)]
    acc = np.zeros((x.shape[0], b.shape[1]), np.float32)
    for i0 in range(0, b.shape[0], kc):
        rows = slice(i0, i0 + kc)
        chunk = sum(xp[p][:, rows] @ bp[q][rows] for p, q in KEPT)
        acc = (acc + chunk.astype(np.float32)).astype(np.float32)
    return acc


def emulate_masked_pair_sums(sim, present, wd, wp, kc=32):
    """numpy twin of ``csrc/panelquad.cu`` on one window.

    P: each row of Wd and Wp is checked (every entry 0 or 1?).  S: mask =
    present & offdiag (present is not assumed symmetric); Yd = Wd .
    ((1 - sim) . mask) and Yp = Wp . mask by the value-row product
    (``piece_products``: three bf16 pieces a value, the kept products, fp32
    chunk sums in i order).  A 0/1 row takes one piece, which changes
    nothing (its other pieces are zero), and its Yp sums exact 0/1 products
    to integers.  Returns (yd, yp, binary), binary the 0/1 flag of every Wp
    row."""
    n = sim.shape[0]
    f32 = np.float32
    mask = (present != 0) & ~np.eye(n, dtype=bool)
    div = np.where(mask, f32(1) - sim, f32(0)).astype(f32)
    binary = ((wp == 0) | (wp == 1)).all(axis=1)
    yd = piece_products(wd.astype(f32), div, kc)
    yp = piece_products(wp.astype(f32), mask.astype(f32), kc)
    return yd, yp, binary


def kernel_operands(seed, n, rd, rp, wp_kind):
    """``operands`` with an asymmetric present (some pairs dropped on one
    side only) and Wp 0/1 (``"01"``) or with one row of other values.  A
    suffix makes the inputs degenerate: ``"-rows"`` empties the first row
    of both stacks (a ghost panel) and makes the second one-hot (a
    one-member panel); ``"-nopresent"`` leaves no pair present."""
    sim, present, wd, wp = operands(seed, n=n, s=128, rd=rd, rp=rp)
    rng = np.random.default_rng(seed + 100)
    present = present & ~(np.triu(rng.random((n, n)) < 0.05, 1))
    if wp_kind.startswith("values"):
        wp[rp // 2] = rng.random(n).astype(np.float32) * 3.0
    if wp_kind.endswith("-rows"):
        wd[:2] = wp[:2] = 0.0
        wd[1, n // 3] = wp[1, n // 3] = 1.0
    if wp_kind.endswith("-nopresent"):
        present[:] = False
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
    (16, 128, 20, 9, "values"), (17, 100, 55, 55, "values"),
    (18, 37, 4, 4, "01-rows"), (19, 100, 6, 6, "values-rows"),
    (20, 37, 4, 4, "01-nopresent"), (21, 100, 6, 6, "values-nopresent")])
def test_kernel_twin_matches_xla(seed, n, rd, rp, wp_kind):
    """The twin against ``masked_pair_sums_xla`` and the port's plain
    version at the drivers' row counts, ragged N, Rd != Rp, a Wp row
    that is not 0/1 (the fp32 branch), an empty and a one-hot row, and no
    pair present: 0/1 rows of Yp exactly equal, the rest rtol 1e-5."""
    sim, present, wd, wp = kernel_operands(seed, n, rd, rp, wp_kind)
    yd, yp, binary = emulate_masked_pair_sums(sim, present, wd, wp)
    assert binary.all() == wp_kind.startswith("01")
    yd_j, yp_j = (np.asarray(a) for a in masked_pair_sums_xla(
        *(jnp.asarray(a) for a in (sim, present, wd, wp))))
    yd_t, yp_t = torch_sums(masked_pair_sums, sim, present, wd, wp)
    for want_d, want_p in ((yd_j, yp_j), (yd_t, yp_t)):
        np.testing.assert_array_equal(yp[binary], want_p[binary])
        np.testing.assert_allclose(yp, want_p, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(yd, want_d, rtol=1e-5, atol=1e-6)


def tab_values(length):
    """The window kernel's tab[d] = 1 - f32(1 - d / max(len, 1)) for every
    count of differing sites it takes (IEEE float32, as the reference)."""
    d = np.arange(65536, dtype=np.float32)
    sim = np.float32(1.0) - d / np.float32(max(length, 1.0))
    return (np.float32(1.0) - sim).astype(np.float32)


def one_minus_sim_values():
    """f32 1 - s for s = 1, 0, the 256 floats below 1 and above 1 (the
    smallest nonzero values 1 - s takes, from 2^-24 up), random similarities
    and negative ones, and the smallest normal float32."""
    rng = np.random.default_rng(5)
    k = np.arange(1, 257, dtype=np.float32)
    sims = np.concatenate([
        np.array([1.0, 0.0, 0.5, 2.0], np.float32),
        np.float32(1.0) - k * np.float32(2.0 ** -24),
        np.float32(1.0) + k * np.float32(2.0 ** -23),
        rng.random(4096, dtype=np.float32),
        -rng.random(64, dtype=np.float32)])
    values = (np.float32(1.0) - sims).astype(np.float32)
    return np.concatenate([values, [np.finfo(np.float32).tiny]]).astype(
        np.float32)


@pytest.mark.parametrize("case", ["tab-1", "tab-83", "tab-5000", "tab-65535",
                                  "one-minus-sim"])
def test_bf16_split_is_exact(case):
    """hi + mid + lo == x bit for bit for every value the kernels split
    into bf16 pieces: the window kernel's tab[d] at four window lengths and
    the masked sums' 1 - sim; each piece a bf16 value, |mid| < 2^-7 |x|
    and |lo| < 2^-15 |x| (the bound behind the dropped products)."""
    x = (tab_values(float(case.split("-")[1])) if case.startswith("tab")
         else one_minus_sim_values())
    pieces = split3(x)
    for piece in pieces:
        assert not (piece.view(np.uint32) & np.uint32(0xFFFF)).any()
    total = (pieces[0].astype(np.float64) + pieces[1].astype(np.float64)
             + pieces[2].astype(np.float64))
    np.testing.assert_array_equal(total, x.astype(np.float64))
    nz = x != 0
    assert (np.abs(pieces[1][nz]) < 2.0 ** -7 * np.abs(x[nz])).all()
    assert (np.abs(pieces[2][nz]) < 2.0 ** -15 * np.abs(x[nz])).all()
    if case == "one-minus-sim":
        assert 0.0 in x and 1.0 in x
        # the smallest nonzero |1 - s| is 2^-24, so every last piece is a
        # normal bf16; the argument ends where it would not be one: the
        # float32 just above the smallest normal keeps a bit that no bf16
        # piece can hold
        one_minus = x[:-1]                  # the last value is FLT_MIN
        assert np.abs(one_minus[one_minus != 0]).min() == np.float32(2.0 ** -24)
        odd = np.nextafter(np.finfo(np.float32).tiny, np.float32(1.0))
        assert sum(float(p[0]) for p in split3(np.array([odd]))) != float(odd)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_piece_products_match_f64_oracle(seed):
    """The value-row product (bf16 pieces, the six kept products, fp32
    chunk sums) against X . B in float64 on an HPRC-shaped window ([512,
    128], five panels): group-weight rows (size / n at each seed) and 0/1
    panel rows against (1 - sim) . mask, and the same rows against the
    mask, rtol 1e-5."""
    from impop_tpu_torch.bench.inputs import hprc_batch
    from impop_tpu_torch.ops.pairdiff import pairwise_identity_plain

    rng = np.random.default_rng(seed)
    geno, member, smask, panels, lengths = hprc_batch(rng, 1)
    sim, present = (t[0].numpy() for t in pairwise_identity_plain(
        *(torch.from_numpy(a) for a in (geno, member, smask, lengths))))
    n = sim.shape[0]
    mask = present & ~np.eye(n, dtype=bool)
    div = np.where(mask, np.float32(1.0) - sim, np.float32(0.0))
    rows = []
    for panel in panels[0]:
        idx = np.flatnonzero(panel)
        seeds = rng.choice(idx, size=max(1, len(idx) // 7), replace=False)
        weights = np.zeros(n, np.float32)
        weights[seeds] = (rng.integers(1, 12, size=len(seeds))
                          / np.float32(len(idx))).astype(np.float32)
        rows += [weights, panel.astype(np.float32)]
    x = np.stack(rows)
    assert (div > 0).sum() > n * n // 4        # a dense (1 - sim) tile
    for b in (div.astype(np.float32), mask.astype(np.float32)):
        want = x.astype(np.float64) @ b.astype(np.float64)
        np.testing.assert_allclose(piece_products(x, b), want, rtol=1e-5,
                                   atol=1e-12)
