"""The whole-window program of the port.

- The plain ``window_stats`` against ``window_stats_pallas`` run in Mosaic
  interpret mode (as tests/test_windowstat.py runs it): disjoint pairs,
  overlapping panels, and the partial-coverage seed_risk case.
- The algorithm of ``csrc/windowstat.cu`` (bit-packed words and popcount
  diffs, links by a per-window bound on the diff, sequential seed walk,
  group size = 1 + what the seed absorbed, stacked X/Y rows, the value
  rows by the bf16 piece product of ``csrc/rowprod.cuh``, the 0/1 rows by
  AND + popcount, row-dots from per-column-tile partials, the host's (Y
  row, X row, column) dot triples) emulated in numpy against the plain
  version and against ``window_stats_pallas`` in interpret mode, so the
  kernel's arithmetic and host-side contract are checked without a card.
- Both on the degenerate windows of ``impop_tpu_torch/bench/degenerate.py``
  against ``window_stats_pallas`` in interpret mode.
The CUDA kernel itself is held against the plain version on a card by
tests/test_torch_gpu.py.

Tolerances: integer outputs exact (S, n, num_groups, pairs_used2, cnt_*,
seed_risk); quad, sum_* and gdxy rtol 1e-5 (float32 sums in another
order).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from impop_tpu.ops.windowstat import window_stats_pallas
from impop_tpu.stats.panelstats import panel_mask_stack as j_stack
from impop_tpu_torch.bench import degenerate
from impop_tpu_torch.ops.windowstat import (_dot_triples, _pad, out_layout,
                                            window_kernel_fits, window_stats,
                                            window_stats_plain)
from impop_tpu_torch.stats.panelstats import gdxy_rows, panel_mask_stack
from test_torch_panelquad import piece_products

torch.set_num_threads(1)
THR, LEN = 0.9995, 5000.0
INT_KEYS = ("n", "num_groups", "pairs_used2", "cnt_aa", "cnt_bb", "cnt_ab",
            "s", "seed_risk")
FLOAT_KEYS = ("quad", "sum_aa", "sum_bb", "sum_ab", "gdxy")


def window(seed, n=128, s=128, p=4, disjoint=True, partial=False):
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, 6, size=n)
    base = rng.integers(0, 2, size=(6, s)).astype(np.int8)
    geno = base[cls]
    geno = np.where(rng.random((n, s)) < 0.01, 1 - geno, geno).astype(np.int8)
    geno[rng.random((n, s)) < 0.05] = -1
    geno[-13:] = -1
    member = np.ones(n, bool)
    member[-13:] = False
    smask = np.ones(s, bool)
    smask[-9:] = False
    if partial:
        geno[: n // 2, s // 2:] = -1
        geno[n // 2:, : s // 2] = -1
    if disjoint:
        pmasks = np.zeros((p, n), bool)
        edges = np.linspace(0, n - 13, p + 1).astype(int)
        for i in range(p):
            pmasks[i, edges[i]:edges[i + 1]] = True
    else:
        pmasks = rng.random((p, n)) < 0.5
    return geno, member, smask, pmasks


def pairs_for(p):
    if p == 2:
        return (0,), (1,)
    return (0, 0, 1, 2), (1, 2, 3, 3)


def torch_args(geno, member, smask, pmasks, pair_a, pair_b, disjoint):
    g, m, sm, pm = (torch.from_numpy(a) for a in (geno, member, smask,
                                                   pmasks))
    stack, ma, mb = panel_mask_stack(pm, m, pair_a, pair_b, disjoint)
    return (g, m, sm, stack, ma, mb, THR, torch.tensor(LEN), pair_a, pair_b,
            disjoint)


def assert_raw(got, want):
    for k in INT_KEYS:
        np.testing.assert_array_equal(np.asarray(got[k], np.float64),
                                      np.asarray(want[k], np.float64),
                                      err_msg=k)
    for k in FLOAT_KEYS:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(want[k], np.float64),
                                   rtol=1e-5, atol=1e-9, err_msg=k)


@pytest.mark.parametrize("disjoint,partial,p", [
    (True, False, 4), (False, False, 4), (True, True, 2)])
def test_plain_matches_pallas_interpret(disjoint, partial, p):
    geno, member, smask, pmasks = window(29, p=p, disjoint=disjoint,
                                         partial=partial)
    pair_a, pair_b = pairs_for(p)
    stack, ma, mb = j_stack(jnp.asarray(pmasks), jnp.asarray(member),
                            jnp.asarray(pair_a), jnp.asarray(pair_b),
                            disjoint)
    with pltpu.force_tpu_interpret_mode():
        want = window_stats_pallas(
            jnp.asarray(geno), jnp.asarray(member), jnp.asarray(smask),
            stack, ma, mb, jnp.float32(THR), jnp.float32(LEN), pair_a,
            pair_b, disjoint, block=128)
    want = {k: np.asarray(v) for k, v in want.items()}
    args = torch_args(geno, member, smask, pmasks, pair_a, pair_b, disjoint)
    got = {k: v.numpy() for k, v in window_stats(*args).items()}
    assert_raw(got, want)
    if partial:
        assert got["seed_risk"] == 1.0, "fixture must trip seed_risk"


def link_dmax(s_cap, length, thr):
    """The kernel's per-window link bound: the largest count of differing
    sites d with float32 1 - d / max(length, 1) > thr (strict), or -1."""
    ln = np.float32(max(length, 1.0))
    d = np.arange(s_cap + 1, dtype=np.float32)
    ok = (np.float32(1.0) - d / ln) > np.float32(thr)
    return int(np.nonzero(ok)[0].max()) if ok.any() else -1


def popcount32(x):
    x = x.astype(np.uint64)
    return np.array([bin(int(v)).count("1") for v in x.ravel()],
                    np.int64).reshape(x.shape)


def pack_words(bits):
    """[..., M] bool, M a multiple of 32 -> [..., M / 32] uint32 words, bit
    b of word k = bits[32 k + b] (the kernel's ballot order)."""
    b = bits.reshape(bits.shape[:-1] + (-1, 32)).astype(np.uint64)
    return (b << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)


def emulate_kernel(geno, member, smask, stack, ma, mb, length, pair_a,
                   pair_b, disjoint, col_tile=64):
    """numpy model of csrc/windowstat.cu for one window -> raw dict: packed
    alt / valid words and popcount diff, links by the diff bound, the
    sequential seed walk (group size = 1 + what the seed absorbed), the
    value rows against (1 - sim) from the rounded table by the bf16 piece
    product (``piece_products``: three pieces a value, the kept products,
    fp32 sums of 32-pair chunks in i order), the 0/1 rows as AND + popcount
    of packed words, and every row-dot summed from per-column-tile
    partials in tile order."""
    n, s = geno.shape
    r_count, q = stack.shape[0], ma.shape[0]
    pq = r_count - (0 if disjoint else 2 * q)
    valid = (geno >= 0) & member[:, None] & smask[None, :]
    a_words = pack_words(valid & (geno > 0))            # [n, s / 32]
    v_words = pack_words(valid)
    both = popcount32(v_words[:, None, :] & v_words[None, :, :]).sum(-1)
    diff = popcount32(v_words[:, None, :] & v_words[None, :, :]
                      & (a_words[:, None, :] ^ a_words[None, :, :])).sum(-1)
    eye = np.eye(n, dtype=bool)
    present = np.where(eye, member[:, None], (both > 0) & member[:, None]
                       & member[None, :])
    upper = np.triu(np.ones((n, n), bool), 1)
    link = present & upper & (diff <= link_dmax(s, length, THR))
    rd, rp = _pad(r_count + 2 * q), _pad(pq + 2 * q)
    x = np.zeros((rd + rp, n), np.float32)
    x[r_count:r_count + q], x[r_count + q:r_count + 2 * q] = ma, mb
    x[rd + pq:rd + pq + q], x[rd + pq + q:rd + pq + 2 * q] = ma, mb
    lay = out_layout(r_count, pq, q)
    out = np.zeros(lay["n_out"], np.float32)
    seeds_any = np.zeros(n, bool)
    for r in range(r_count):                # phase B: the warp's walk
        todo = stack[r] & member
        n_r = int(todo.sum())
        groups = 0
        for i in range(n):
            if not todo[i]:
                continue
            todo[i] = False
            size = 1 + int((link[i] & todo).sum())
            todo &= ~link[i]
            x[r, i] = np.float32(size) / np.float32(max(n_r, 1))
            if r < pq:
                x[rd + r, i] = 1.0
            seeds_any[i] = True
            groups += 1
        out[lay["n"] + r], out[lay["num_groups"] + r] = n_r, groups
    ln = np.float32(max(length, 1.0))
    table = np.float32(1.0) - (np.float32(1.0)
                               - np.arange(s + 1, dtype=np.float32) / ln)
    mask = present & ~eye
    div = np.where(mask, table[np.minimum(diff, s)], np.float32(0.0))
    y_val = piece_products(x[:rd], div.astype(np.float32))
    # 0/1 rows: popcount of the row's packed bits and present column j
    # without the diagonal
    xb = pack_words(x[rd:] != 0)            # [rp, n / 32]
    col = pack_words(mask.T)                # column j of mask, bit-packed
    y_bin = popcount32(xb[:, None, :] & col[None, :, :]).sum(-1)
    y = np.concatenate([y_val, y_bin.astype(np.float32)])
    ia, ib = gdxy_rows(pair_a, pair_b, pq, disjoint)
    for yr, xr, c in _dot_triples(r_count, pq, q, tuple(ia), tuple(ib)):
        parts = [np.float32((y[yr, j0:j0 + col_tile]
                             * x[xr, j0:j0 + col_tile]).sum(dtype=np.float32))
                 for j0 in range(0, n, col_tile)]
        acc = np.float32(0.0)
        for part in parts:
            acc = np.float32(acc + part)
        out[c] = acc
    cols_alt = (valid & (geno > 0)).any(0)
    cols_ref = (valid & (geno == 0)).any(0)
    out[lay["s"]] = (cols_alt & cols_ref).sum()
    out[lay["seed_risk"]] = float(
        (seeds_any[:, None] & seeds_any[None, :] & ~present & ~eye).any())
    sizes = {"quad": r_count, "n": r_count, "num_groups": r_count,
             "pairs_used2": pq, "sum_aa": q, "cnt_aa": q, "sum_bb": q,
             "cnt_bb": q, "sum_ab": q, "cnt_ab": q, "gdxy": q}
    res = {k: out[lay[k]:lay[k] + m] for k, m in sizes.items()}
    res["s"], res["seed_risk"] = out[lay["s"]], out[lay["seed_risk"]]
    return res


@pytest.mark.parametrize("length,thr", [(5000.0, THR), (37.0, 0.9),
                                        (0.0, 0.5), (200_000.0, 0.99999)])
def test_link_bound_equals_the_float32_rule(length, thr):
    """diff <= dmax is sim > thr for every count the window can hold."""
    s = 4096
    dmax = link_dmax(s, length, thr)
    d = np.arange(s + 1, dtype=np.float32)
    sim = np.float32(1.0) - d / np.float32(max(length, 1.0))
    np.testing.assert_array_equal(sim > np.float32(thr),
                                  np.arange(s + 1) <= dmax)


@pytest.mark.parametrize("disjoint,partial,p", [
    (True, False, 4), (False, False, 4), (True, True, 2)])
def test_kernel_emulation_matches_pallas_interpret(disjoint, partial, p):
    """The kernel's arithmetic (packed words, popcounts, tile partials)
    against the JAX package's window_stats_pallas in interpret mode."""
    geno, member, smask, pmasks = window(33, p=p, disjoint=disjoint,
                                         partial=partial)
    pair_a, pair_b = pairs_for(p)
    stack, ma, mb = j_stack(jnp.asarray(pmasks), jnp.asarray(member),
                            jnp.asarray(pair_a), jnp.asarray(pair_b),
                            disjoint)
    with pltpu.force_tpu_interpret_mode():
        want = window_stats_pallas(
            jnp.asarray(geno), jnp.asarray(member), jnp.asarray(smask),
            stack, ma, mb, jnp.float32(THR), jnp.float32(LEN), pair_a,
            pair_b, disjoint, block=128)
    want = {k: np.asarray(v) for k, v in want.items()}
    got = emulate_kernel(geno, member, smask, np.asarray(stack),
                         np.asarray(ma), np.asarray(mb), LEN, pair_a,
                         pair_b, disjoint)
    assert_raw(got, want)


@pytest.mark.parametrize("disjoint,partial,p", [
    (True, False, 4), (False, False, 4), (True, True, 2)])
def test_kernel_algorithm_emulation_matches_plain(disjoint, partial, p):
    geno, member, smask, pmasks = window(31, p=p, disjoint=disjoint,
                                         partial=partial)
    pair_a, pair_b = pairs_for(p)
    args = torch_args(geno, member, smask, pmasks, pair_a, pair_b, disjoint)
    want = {k: v.numpy() for k, v in window_stats_plain(*args).items()}
    stack, ma, mb = (t.numpy() for t in args[3:6])
    got = emulate_kernel(geno, member, smask, stack, ma, mb, LEN, pair_a,
                         pair_b, disjoint)
    assert_raw(got, want)


def test_padding_windows_are_inert():
    """All-zero wire rows decode to no members and length 0: every output
    is finite and zero."""
    geno = torch.full((2, 64, 128), -1, dtype=torch.int8)
    member = torch.zeros((2, 64), dtype=torch.bool)
    smask = torch.zeros((2, 128), dtype=torch.bool)
    pm = torch.zeros((2, 3, 64), dtype=torch.bool)
    stack, ma, mb = panel_mask_stack(pm, member, (0, 0, 1), (1, 2, 2), True)
    out = window_stats(geno, member, smask, stack, ma, mb, THR,
                       torch.zeros(2), (0, 0, 1), (1, 2, 2), True)
    for k, v in out.items():
        assert torch.isfinite(v).all() and not v.any(), k


@pytest.mark.parametrize("n_cap,s_cap,fits", [
    (512, 128, True), (512, 65504, True), (32, 32, True),
    (512, 65536, False), (512, 65664, False), (37, 128, False),
    (64, 100, False), (0, 128, False), (64, 0, False)])
def test_window_kernel_fits(n_cap, s_cap, fits):
    assert window_kernel_fits(n_cap, s_cap) is fits


@pytest.mark.parametrize("disjoint", [True, False])
def test_composed_route_above_the_cap_matches_plain_and_jax(monkeypatch,
                                                            disjoint):
    """Windows of 65 664 sites (the scan's cap_s past 65 535) take the
    composed route: identity, S and fused_panel_stats.  Its PanelStats
    equal the epilogue on ``window_stats_plain`` and the JAX
    ``fused_window_stats`` of each window (integers exact, π rtol 1e-5,
    Fst atol 2e-3)."""
    import impop_tpu_torch.ops.windowstat as tws
    from impop_tpu.stats.panelstats import fused_window_stats as j_fused
    from impop_tpu_torch.stats.panelstats import (_assemble_from_kernel,
                                                  fused_window_stats)

    def refuse(*a, **k):
        raise AssertionError("the window kernel's wrapper was called")

    monkeypatch.setattr(tws, "window_stats", refuse)
    w, s = 2, 65_664
    data = [window(40 + wi, n=32, s=s, p=4, disjoint=disjoint)
            for wi in range(w)]
    geno, member, smask, pmasks = (np.stack(x) for x in zip(*data))
    pair_a, pair_b = pairs_for(4)
    lengths = np.array([300_000.0, 2_000_000.0], np.float32)
    t = [torch.from_numpy(a) for a in (geno, member, smask, lengths, pmasks)]
    sim, pres, s_count, got = fused_window_stats(
        *t, pair_a, pair_b, THR, disjoint, return_matrices=False)
    assert sim is None and pres is None

    g, m, sm, ln, pm = t
    stack, ma, mb = panel_mask_stack(pm, m, pair_a, pair_b, disjoint)
    raw = window_stats_plain(g, m, sm, stack, ma, mb, THR, ln, pair_a,
                             pair_b, disjoint)
    pq = pmasks.shape[-2] + len(pair_a)
    plain = _assemble_from_kernel(raw, pq, len(pair_a), pair_a, pair_b,
                                  disjoint)
    np.testing.assert_array_equal(s_count.numpy(), raw["s"].numpy())
    assert int(s_count.min()) > 1000
    for name, want in (("plain", plain), ("jax", None)):
        for wi in range(w):
            if want is None:
                want_w = j_fused(
                    jnp.asarray(geno[wi]), jnp.asarray(member[wi]),
                    jnp.asarray(smask[wi]), jnp.float32(lengths[wi]),
                    jnp.asarray(pmasks[wi]), jnp.asarray(pair_a),
                    jnp.asarray(pair_b), jnp.float32(THR), disjoint,
                    return_matrices=False)
                assert int(want_w[2]) == int(s_count[wi])
                want_w = want_w[3]
            else:
                want_w = type(want)(*(
                    type(f)(*(x[wi] for x in f)) if isinstance(f, tuple)
                    else f[wi] for f in want))
            got_w = type(got)(*(
                type(f)(*(x[wi] for x in f)) if isinstance(f, tuple)
                else f[wi] for f in got))
            for f in ("n", "num_groups", "pairs_used", "pairs_missing"):
                np.testing.assert_array_equal(
                    np.asarray(getattr(got_w, f)),
                    np.asarray(getattr(want_w, f)), err_msg=f"{name} {f}")
            np.testing.assert_allclose(np.asarray(got_w.pi),
                                       np.asarray(want_w.pi), rtol=1e-5,
                                       atol=1e-9, err_msg=f"{name} pi")
            for res in ("hudson", "hudson_grouped"):
                for f in ("pi_a", "pi_b", "pi_xy", "dxy"):
                    np.testing.assert_allclose(
                        np.asarray(getattr(getattr(got_w, res), f)),
                        np.asarray(getattr(getattr(want_w, res), f)),
                        rtol=1e-5, atol=1e-9, err_msg=f"{name} {res}.{f}")
                np.testing.assert_allclose(
                    np.asarray(getattr(got_w, res).fst),
                    np.asarray(getattr(want_w, res).fst), atol=2e-3,
                    err_msg=f"{name} {res}.fst")
            assert bool(got_w.seed_risk) == bool(want_w.seed_risk)


def test_wrapper_refuses_other_devices():
    geno, member, smask, pmasks = window(3)
    args = list(torch_args(geno, member, smask, pmasks, *pairs_for(4),
                           True))
    args[0] = args[0].to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        window_stats(*args)


@pytest.mark.parametrize("overlapping", [False, True])
@pytest.mark.parametrize("kind", degenerate.KINDS)
def test_plain_matches_pallas_interpret_on_degenerate_window(kind,
                                                             overlapping):
    """The plain version the card's window kernel is held to, and the
    numpy model of the kernel's algorithm, against window_stats_pallas in
    interpret mode on the degenerate windows of ``bench/degenerate.py``
    (no active site, monomorphic, every row missing, no member) with an
    empty and a one-member panel among five, side by side and
    overlapping (ten pairs)."""
    geno, member, smask, _, n_hap = degenerate.degenerate_windows(
        31, 1, 128, 128, kind)
    pmasks = degenerate.degenerate_panels(31, 1, 128, n_hap, overlapping)[0]
    geno, member, smask = geno[0], member[0], smask[0]
    pairs = [(i, j) for i in range(5) for j in range(i + 1, 5)]
    pair_a, pair_b = (tuple(a for a, _ in pairs), tuple(b for _, b in pairs))
    disjoint = not overlapping
    stack, ma, mb = j_stack(jnp.asarray(pmasks), jnp.asarray(member),
                            jnp.asarray(pair_a), jnp.asarray(pair_b),
                            disjoint)
    with pltpu.force_tpu_interpret_mode():
        want = window_stats_pallas(
            jnp.asarray(geno), jnp.asarray(member), jnp.asarray(smask),
            stack, ma, mb, jnp.float32(THR), jnp.float32(LEN), pair_a,
            pair_b, disjoint, block=128)
    want = {k: np.asarray(v) for k, v in want.items()}
    args = torch_args(geno, member, smask, pmasks, pair_a, pair_b, disjoint)
    got = {k: v.numpy() for k, v in window_stats(*args).items()}
    assert_raw(got, want)
    assert got["s"] == 0.0
    assert_raw(emulate_kernel(geno, member, smask, np.asarray(stack),
                              np.asarray(ma), np.asarray(mb), LEN, pair_a,
                              pair_b, disjoint), want)
