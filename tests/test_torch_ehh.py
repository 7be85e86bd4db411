"""impop_tpu_torch.stats.ehh / ops.ehhdeath against the JAX package (CPU
backend) and against an int64 numpy oracle.

Tolerances: carrier counts and step sums exact.  Areas against
``impop_tpu.stats.ehh.ehh_area_dynamic`` at rtol 1e-6: the JAX package
sums steps in float32, exact only while C(N, 2) * S stays below 2^24
(these shapes do), and divides by the same float32 denominator.  Past
2^24 the port is held to the int64 oracle only."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from impop_tpu.ops.ehhdeath import ehh_area_pallas
from impop_tpu.stats.ehh import ehh_area_dynamic as j_ehh_area_dynamic
from impop_tpu_torch.ops.ehhdeath import ehh_area, ehh_area_plain
from impop_tpu_torch.stats.ehh import ehh_area_dynamic

torch.set_num_threads(1)


def windows(seed, w, n, s, p_active=0.85):
    """Binarised 0/1 windows with haplotype classes, so pairs share runs."""
    rng = np.random.default_rng(seed)
    geno = np.zeros((w, n, s), np.int8)
    for wi in range(w):
        base = rng.integers(0, 2, size=(4, s)).astype(np.int8)
        g = base[rng.integers(0, 4, size=n)]
        geno[wi] = np.where(rng.random((n, s)) < 0.03, 1 - g, g)
    member = rng.random((w, n)) < 0.9
    smask = rng.random((w, s)) < p_active
    return geno, member, smask


def focals_for(smask):
    """Per window: first active, last active, middle active, an inactive
    column, then the cycle again."""
    out = []
    for wi, row in enumerate(smask):
        act = np.nonzero(row)[0]
        inact = np.nonzero(~row)[0]
        picks = [act[0], act[-1], act[len(act) // 2],
                 inact[0] if inact.size else act[1]]
        out.append(int(picks[wi % 4]))
    return np.asarray(out, np.int32)


def jax_areas(geno, member, smask, focal):
    fn = jax.jit(jax.vmap(lambda g, m, sm, f: j_ehh_area_dynamic(
        g, m, sm, f, alleles=(0, 1))))
    a, c = fn(jnp.asarray(geno), jnp.asarray(member), jnp.asarray(smask),
              jnp.asarray(focal))
    return np.asarray(a), np.asarray(c)


def torch_areas(geno, member, smask, focal):
    a, c = ehh_area_dynamic(torch.from_numpy(geno), torch.from_numpy(member),
                            torch.from_numpy(smask), torch.from_numpy(focal))
    return a.numpy(), c.numpy()


@pytest.mark.parametrize("seed,n,s", [(1, 64, 50), (2, 96, 128),
                                      (3, 40, 200)])
def test_ehh_area_dynamic_matches_jax(seed, n, s):
    geno, member, smask = windows(seed, 8, n, s)
    focal = focals_for(smask)
    a_j, c_j = jax_areas(geno, member, smask, focal)
    a_t, c_t = torch_areas(geno, member, smask, focal)
    np.testing.assert_array_equal(c_t, c_j)
    np.testing.assert_allclose(a_t, a_j, rtol=1e-6, atol=0)


def test_ehh_area_dynamic_padding_independent():
    """Widening the tile with inactive columns changes nothing."""
    geno, member, smask = windows(4, 6, 64, 50)
    focal = focals_for(smask)
    pad = 46
    g2 = np.concatenate([geno, np.ones((6, 64, pad), np.int8)], axis=2)
    sm2 = np.concatenate([smask, np.zeros((6, pad), bool)], axis=1)
    a1, c1 = torch_areas(geno, member, smask, focal)
    a2, c2 = torch_areas(g2, member, sm2, focal)
    np.testing.assert_array_equal(a2, a1)
    np.testing.assert_array_equal(c2, c1)


def test_ehh_missing_calls_and_focal_outside_tile():
    """A missing call (-1) counts as allele 0, in the sites and at the
    focal column; a focal past the tile reads every member as allele 0."""
    geno, member, smask = windows(5, 4, 48, 64)
    geno[np.random.default_rng(0).random(geno.shape) < 0.1] = -1
    focal = focals_for(smask)
    focal[3] = 64
    xb = (geno == 1).astype(np.int8)
    a_j, c_j = jax_areas(xb, member, smask, focal)
    a_t, c_t = torch_areas(geno, member, smask, focal)
    np.testing.assert_array_equal(c_t, c_j)
    np.testing.assert_allclose(a_t, a_j, rtol=1e-6, atol=0)
    assert c_t[3, 1] == 0 and c_t[3, 0] == member[3].sum()


@pytest.mark.parametrize("where", ["first", "middle", "last"])
def test_ehh_area_plain_matches_pallas_interpret(where):
    """The plain sums against ehh_area_pallas (interpret mode) on the
    compacted operands, as tests/test_ehh.py holds the Pallas kernel."""
    from jax.experimental.pallas import tpu as pltpu

    geno, member, smask = windows(6, 1, 128, 128, p_active=0.9)
    g, m, sm = geno[0], member[0], smask[0]
    act = np.nonzero(sm)[0]
    focal = {"first": act[0], "middle": act[len(act) // 2],
             "last": act[-1]}[where]
    sums, carr = ehh_area_plain(torch.from_numpy(g), torch.from_numpy(m),
                                torch.from_numpy(sm),
                                torch.tensor(int(focal)))
    n_act = int(sm.sum())
    xc = np.zeros((128, 128), np.float32)
    xc[:, :n_act] = g[:, sm]
    call = g[:, focal]
    carr_f = np.stack([(m & (call == al)).astype(np.float32)
                       for al in (0, 1)])
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ehh_area_pallas(
            jnp.asarray(xc), jnp.asarray(carr_f),
            jnp.float32(int(sm[:focal].sum())), jnp.float32(n_act)))
    # integer sums below 2^24: exact in the kernel's float32
    np.testing.assert_array_equal(
        sums.sum(-2).numpy().astype(np.float32), want)
    np.testing.assert_array_equal(carr.numpy(), carr_f.sum(1))


def oracle_sums(geno, member, smask, focal):
    """int64 numpy oracle: per pair, the first / last differing compacted
    site around the focal rank.  Returns (sums [2 directions (left,
    right), 2 alleles], carriers [2])."""
    xb = (geno == 1)[:, smask]
    n_act = xb.shape[1]
    fi = int(smask[:max(focal, 0)].sum())
    call = geno[:, focal] == 1 if 0 <= focal < geno.shape[1] else \
        np.zeros(geno.shape[0], bool)
    sums = np.zeros((2, 2), np.int64)
    carr = np.zeros(2, np.int64)
    for a in (0, 1):
        rows = np.nonzero(member & (call == bool(a)))[0]
        carr[a] = rows.size
        x = xb[rows]
        d = x[:, None, :] != x[None, :, :]                  # [c, c, n_act]
        # a False sentinel column keeps argmax defined on empty sides
        stop = np.zeros(d.shape[:2] + (1,), bool)
        right = np.concatenate([d[:, :, fi + 1:], stop], axis=-1)
        first = np.where(right.any(-1), right.argmax(-1) + fi + 1, n_act)
        left = np.concatenate([stop, d[:, :, :fi]], axis=-1)[:, :, ::-1]
        last = np.where(left.any(-1), fi - 1 - left.argmax(-1), -1)
        sums[0, a] = np.triu(np.maximum(fi - 1 - last, 0), 1).sum()
        sums[1, a] = np.triu(np.maximum(first - fi - 1, 0), 1).sum()
    return sums, carr


def test_ehh_area_plain_int64_past_2_24():
    """Long identical runs push the step sum past 2^24, where a float32
    accumulator is no longer exact; the plain sums stay exact in int64."""
    rng = np.random.default_rng(8)
    n, s = 192, 2048
    base = rng.integers(0, 2, size=s).astype(np.int8)
    geno = np.where(rng.random((n, s)) < 2e-4, 1 - base, base)[None]
    geno = geno.astype(np.int8)
    member = np.ones((1, n), bool)
    member[0, -5:] = False
    smask = np.ones((1, s), bool)
    smask[0, 3::97] = False
    focal = np.asarray([700], np.int32)
    sums, carr = ehh_area(*(torch.from_numpy(a) for a in
                            (geno, member, smask, focal)))
    want_s, want_c = oracle_sums(geno[0], member[0], smask[0], 700)
    assert int(sums.max()) > 1 << 24
    np.testing.assert_array_equal(sums.numpy()[0], want_s)
    np.testing.assert_array_equal(carr.numpy()[0], want_c)


def test_ehh_area_oracle_small_mixed():
    """The oracle on small mixed windows, every focal kind."""
    geno, member, smask = windows(9, 8, 40, 70)
    geno[:, :, 5] = -1
    focal = focals_for(smask)
    sums, carr = ehh_area_plain(*(torch.from_numpy(a) for a in
                                  (geno, member, smask, focal)))
    for wi in range(8):
        want_s, want_c = oracle_sums(geno[wi], member[wi], smask[wi],
                                     int(focal[wi]))
        np.testing.assert_array_equal(sums.numpy()[wi], want_s)
        np.testing.assert_array_equal(carr.numpy()[wi], want_c)


U64 = np.uint64


def _low_bit(d):
    """Index of the lowest set bit of each nonzero uint64 (__ffsll - 1)."""
    return np.log2((d & (~d + U64(1))).astype(np.float64)).astype(np.int64)


def _high_bit(d):
    """Index of the highest set bit of each nonzero uint64 (63 -
    __clzll), exact through two 32-bit halves."""
    hi, lo = (d >> U64(32)).astype(np.float64), (d & U64(0xffffffff)).astype(
        np.float64)
    with np.errstate(divide="ignore"):
        return np.where(hi > 0, 32 + np.floor(np.log2(hi)),
                        np.floor(np.log2(lo))).astype(np.int64)


def emulate_ehh_kernel(geno, member, smask, focal, tile=64):
    """numpy twin of ``csrc/ehhdeath.cu`` on a batch: P1 compacts each
    row's alt bits of every 32-site word by in-word rank (the warp
    OR-reduction) and streams the pieces into 64-bit words at the word's
    base rank; it lists each allele's carriers in ascending row order from
    32-row ballots and a prefix count.  P2 walks the tiles of tile x tile
    list positions on or above the diagonal of each allele's list and
    finds each pair's death ranks word by word: the first nonzero XOR
    word above fi (lowest bit) and the last below fi (highest bit).
    Returns (sums [W, 2 directions (left, right), 2 alleles] int64,
    carriers [W, 2] int64)."""
    w_count, n, s = geno.shape
    sw = -(-s // 32)
    sums = np.zeros((w_count, 2, 2), np.int64)
    carr = np.zeros((w_count, 2), np.int64)
    for w in range(w_count):
        g, sm, f = geno[w], smask[w], int(focal[w])
        act = [sum(1 << b for b in range(32) if 32 * k + b < s
                   and sm[32 * k + b]) for k in range(sw)]
        cnt = [bin(a).count("1") for a in act]
        base = np.concatenate([[0], np.cumsum(cnt)[:-1]]).astype(int)
        n_act = int(sum(cnt))
        fi = (0 if f <= 0 else n_act if f >= s else
              int(base[f >> 5]) + bin(act[f >> 5] & ((1 << (f & 31)) - 1))
              .count("1"))
        nw = -(-n_act // 64)
        xc = np.zeros((n, max(nw, 1)), U64)
        cur, cur_k = np.zeros(n, U64), 0
        for k in range(sw):
            if not act[k]:
                continue
            c = np.zeros(n, U64)
            for lane in range(32):
                if (act[k] >> lane) & 1:
                    q = bin(act[k] & ((1 << lane) - 1)).count("1")
                    c |= (g[:, 32 * k + lane] == 1).astype(U64) << U64(q)
            kk, off = int(base[k]) >> 6, int(base[k]) & 63
            if kk != cur_k:
                xc[:, cur_k], cur, cur_k = cur, np.zeros(n, U64), kk
            cur |= c << U64(off)
            if off + cnt[k] > 64:
                xc[:, cur_k], cur, cur_k = cur, c >> U64(64 - off), kk + 1
        if n_act:
            xc[:, cur_k] = cur

        call = g[:, f] == 1 if 0 <= f < s else np.zeros(n, bool)
        lists = []
        for a in (0, 1):
            flag = member[w] & (call == bool(a))
            words = [flag[32 * c:32 * c + 32] for c in range(-(-n // 32))]
            start = np.concatenate([[0], np.cumsum([x.sum() for x in words])])
            rows = np.zeros(int(start[-1]), np.int64)
            for c, x in enumerate(words):
                rows[start[c] + np.cumsum(x)[x] - 1] = 32 * c + np.nonzero(x)[0]
            lists.append(rows)
            carr[w, a] = rows.size
        if nw == 0:        # no active site: no word to walk, no step
            continue

        keep_r = np.full(nw, ~U64(0))
        keep_l = np.full(nw, ~U64(0))
        kr0, kl0 = (fi + 1) >> 6, (fi - 1) >> 6
        if kr0 < nw:
            keep_r[kr0] = ~U64(0) << U64((fi + 1) & 63)
            keep_r[:kr0] = 0
        else:
            keep_r[:] = 0
        keep_l[kl0 + 1:] = 0
        if fi >= 1 and (fi - 1) & 63 < 63:
            keep_l[kl0] = (U64(2) << U64((fi - 1) & 63)) - U64(1)
        for a, rows in enumerate(lists):
            t = -(-rows.size // tile)
            for ta in range(t):
                for tb in range(ta, t):
                    ra = rows[ta * tile:(ta + 1) * tile]
                    rb = rows[tb * tile:(tb + 1) * tile]
                    d = xc[ra][:, None, :nw] ^ xc[rb][None, :, :nw]
                    valid = np.ones((ra.size, rb.size), bool)
                    if ta == tb:
                        valid = np.triu(valid, 1)
                    dr, dl = d & keep_r, d & keep_l
                    hit_r, hit_l = dr != 0, dl != 0
                    kr = np.argmax(hit_r, -1)                    # first word
                    kl = nw - 1 - np.argmax(hit_l[..., ::-1], -1)  # last word
                    wr = np.take_along_axis(dr, kr[..., None], -1)[..., 0]
                    wl = np.take_along_axis(dl, kl[..., None], -1)[..., 0]
                    death_r = np.where(hit_r.any(-1),
                                       64 * kr + _low_bit(wr | (wr == 0)),
                                       n_act)
                    death_l = np.where(hit_l.any(-1),
                                       64 * kl + _high_bit(wl | (wl == 0)),
                                       -1)
                    right = np.maximum(np.minimum(death_r, n_act) - fi - 1, 0)
                    left = np.maximum(fi - 1 - death_l, 0)
                    sums[w, 0, a] += int(left[valid].sum())
                    sums[w, 1, a] += int(right[valid].sum())
    return sums, carr


def ehh_edge_windows(seed):
    """Six windows of 128 rows and S = 200 (not a multiple of 64): focal
    on the first and the last active site, in the middle, a window with
    no active site, one whose focal column gives every member allele 0
    (no carrier of allele 1), and one with every member a carrier of
    allele 1."""
    geno, member, smask = windows(seed, 6, 128, 200)
    geno[:, :, 7] = -1
    focal = np.zeros(6, np.int32)
    for wi in range(6):
        act = np.nonzero(smask[wi])[0]
        focal[wi] = (act[0], act[-1], act[len(act) // 2], 0, act[3],
                     act[5])[wi]
    smask[3] = False
    geno[4, :, focal[4]] = 0
    geno[5, :, focal[5]] = 1
    return geno, member, smask, focal


def test_ehh_kernel_emulation_matches_plain_and_jax():
    """The kernel's algorithm on the edge windows: sums equal to the plain
    version, areas equal to ``impop_tpu.stats.ehh.ehh_area_dynamic``
    (rtol 1e-6, the JAX float32 sums are exact below 2^24)."""
    geno, member, smask, focal = ehh_edge_windows(11)
    sums, carr = emulate_ehh_kernel(geno, member, smask, focal)
    want_s, want_c = ehh_area_plain(*(torch.from_numpy(a) for a in
                                      (geno, member, smask, focal)))
    np.testing.assert_array_equal(sums, want_s.numpy())
    np.testing.assert_array_equal(carr, want_c.numpy())
    assert carr[4, 1] == 0 and carr[5, 0] == 0 and sums[3].sum() == 0
    assert (sums[[0, 1, 2]].sum(1) > 0).all()
    # focal on the first / last active site: no left / right steps
    assert (sums[0, 0] == 0).all() and (sums[1, 1] == 0).all()
    a_j, c_j = jax_areas((geno == 1).astype(np.int8), member, smask, focal)
    np.testing.assert_array_equal(carr, c_j)
    denom = np.maximum(carr * (carr - 1) / 2, 1).astype(np.float32)
    np.testing.assert_allclose(sums.sum(1).astype(np.float32) / denom, a_j,
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("where", ["first", "middle", "last"])
def test_ehh_kernel_emulation_matches_pallas_interpret(where):
    """The kernel's algorithm against ``ehh_area_pallas`` (interpret mode)
    on the compacted operands, at N = 512 (several tiles per list)."""
    from jax.experimental.pallas import tpu as pltpu

    geno, member, smask = windows(12, 1, 512, 128, p_active=0.9)
    g, m, sm = geno[0], member[0], smask[0]
    act = np.nonzero(sm)[0]
    focal = {"first": act[0], "middle": act[len(act) // 2],
             "last": act[-1]}[where]
    sums, carr = emulate_ehh_kernel(geno, member, smask,
                                    np.asarray([focal], np.int32))
    n_act = int(sm.sum())
    xc = np.zeros((512, 128), np.float32)
    xc[:, :n_act] = g[:, sm]
    carr_f = np.stack([(m & (g[:, focal] == al)).astype(np.float32)
                       for al in (0, 1)])
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ehh_area_pallas(
            jnp.asarray(xc), jnp.asarray(carr_f),
            jnp.float32(int(sm[:focal].sum())), jnp.float32(n_act)))
    assert carr.min() > 64          # each list spans more than one tile
    np.testing.assert_array_equal(sums[0].sum(0).astype(np.float32), want)
    np.testing.assert_array_equal(carr[0], carr_f.sum(1))


def test_ehh_kernel_emulation_int64_past_2_24():
    """Long identical runs past 2^24 in one sum (the left one: the focal
    sits far right): the kernel's algorithm equals the int64 oracle."""
    rng = np.random.default_rng(13)
    n, s = 192, 2048
    base = rng.integers(0, 2, size=s).astype(np.int8)
    geno = np.where(rng.random((n, s)) < 2e-4, 1 - base, base)[None]
    geno = geno.astype(np.int8)
    member = np.ones((1, n), bool)
    member[0, 100:104] = False
    smask = np.ones((1, s), bool)
    smask[0, 5::89] = False
    focal = np.asarray([1600], np.int32)
    sums, carr = emulate_ehh_kernel(geno, member, smask, focal)
    want_s, want_c = oracle_sums(geno[0], member[0], smask[0], 1600)
    assert int(sums.max()) > 1 << 24
    np.testing.assert_array_equal(sums[0], want_s)
    np.testing.assert_array_equal(carr[0], want_c)


def test_ehh_area_dispatch():
    """CPU tensors take the plain version (no launch); other devices
    raise."""
    geno, member, smask = windows(10, 2, 32, 40)
    args = [torch.from_numpy(a) for a in (geno, member, smask,
                                          focals_for(smask))]
    before = ehh_area.launches
    got = ehh_area(*args)
    want = ehh_area_plain(*args)
    assert ehh_area.launches == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="unsupported device"):
        ehh_area(*(a.to("meta") for a in args))


@pytest.mark.parametrize("kind", ["one_carrier", "monomorphic", "no_member"])
def test_ehh_kernel_emulation_on_degenerate_windows(kind):
    """The kernel's algorithm against the plain version on the EHH kinds
    of ``bench/degenerate.py`` at the first, middle and last of nine
    windows (N = 37, not a multiple of the 64-row tile): one carrier of
    the focal allele, monomorphic windows, windows without members."""
    from impop_tpu_torch.bench import degenerate

    geno, member, smask, _, n_hap = degenerate.degenerate_windows(
        5, 9, 37, 70, None if kind == "one_carrier" else kind)
    focal = np.array([np.nonzero(r)[0][np.count_nonzero(r) // 2]
                      for r in smask], np.int32)
    rows = degenerate.degenerate_rows(9)
    if kind == "one_carrier":
        for wi in rows:
            col = geno[wi, :, focal[wi]]
            col[col == 1] = 0
            col[wi % n_hap] = 1
    sums, carr = emulate_ehh_kernel(geno, member, smask, focal)
    want_s, want_c = ehh_area_plain(*(torch.from_numpy(a) for a in
                                      (geno, member, smask, focal)))
    np.testing.assert_array_equal(sums, want_s.numpy())
    np.testing.assert_array_equal(carr, want_c.numpy())
    if kind == "one_carrier":
        assert (carr[rows, 1] == 1).all()
    if kind == "no_member":
        assert (carr[rows] == 0).all() and sums[rows].sum() == 0
