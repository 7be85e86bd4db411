"""The port's scan step against the JAX step on the same wire buffer.

One ``pack_scan_batch`` buffer goes through ``impop_tpu.cli._scan_step``
(on one CPU device: a longer device tuple would shard_map the batch) and
through ``impop_tpu_torch.scanstep.scan_step``; the packed rows must agree:
integer columns (S, n, seed_risk, EHH carriers, AFS bins) exact, π, D and
EHH areas rtol 1e-5, Fst columns atol 2e-3, NaN in the same places, with
every option of the step (column-mode weights, EHH, AFS) alone and
together.  Likewise the exact grouped-Fst recompute."""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from impop_tpu.cli import (_scan_step, _scan_step_fstg_exact,
                           pack_scan_batch)
from impop_tpu_torch.scanstep import (deal_wire, row_layout, scan_step,
                                      scan_step_fstg_exact, wire_unpack)

torch.set_num_threads(1)
THR = 0.999


def on_cpu(flat):
    """The wire batch as the scan hands it to the step on one device."""
    return deal_wire(flat, torch.device("cpu"))


def one_device():
    return (jax.devices()[0],)


def batch(seed, w=3, n=128, s=128, n_mem=110, p=4, disjoint=True,
          partial=False, use_weights=False, use_ehh=False):
    rng = np.random.default_rng(seed)
    geno = np.full((w, n, s), -1, np.int8)
    member = np.zeros((w, n), bool)
    smask = np.zeros((w, s), bool)
    for wi in range(w):
        cls = rng.integers(0, 5, size=n_mem)
        base = rng.integers(0, 2, size=(5, s)).astype(np.int8)
        g = base[cls]
        g = np.where(rng.random((n_mem, s)) < 0.01, 1 - g, g).astype(np.int8)
        g[rng.random((n_mem, s)) < 0.03] = -1
        if partial and wi == 0:
            g[: n_mem // 2, s // 2:] = -1
            g[n_mem // 2:, : s // 2] = -1
        geno[wi, :n_mem] = g
        member[wi, :n_mem] = True
        smask[wi, :s - 5] = True
    if disjoint:
        panels = np.zeros((w, p, n), bool)
        size = n_mem // p
        for i in range(p):
            panels[:, i, i * size:(i + 1) * size] = True
    else:
        panels = rng.random((w, p, n)) < 0.5
    lengths = np.full(w, 5000, np.uint32)
    lengths[-1] = 0                      # a padding window
    member[-1] = False
    # integer column weights (indel lengths) with one structural variant
    wts = rng.integers(1, 40, size=(w, s)).astype(np.float32)
    wts[:, 17] = 60_000.0
    # focal columns: middle, first and last active site in turn
    focals = np.asarray([(s - 5) // 2, 0, s - 6] * w, np.uint32)[:w]
    flat = pack_scan_batch(geno, member, smask, panels, lengths,
                           wts if use_weights else None, use_weights,
                           focals if use_ehh else None)
    pairs = tuple((i, j) for i in range(p) for j in range(i + 1, p))
    return flat, (geno, member, smask, panels, lengths, wts, focals), pairs


def assert_rows(got, want, p_count, n_pairs, want_ehh=False):
    lay = row_layout(p_count, n_pairs, want_ehh)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    for key in ("s", "n", "risk"):
        np.testing.assert_array_equal(got[:, lay[key]], want[:, lay[key]],
                                      err_msg=key)
    np.testing.assert_array_equal(got[:, lay["afs"]:], want[:, lay["afs"]:])
    e = lay["ehh"]
    np.testing.assert_array_equal(got[:, e + 2:lay["afs"]],
                                  want[:, e + 2:lay["afs"]])
    np.testing.assert_allclose(got[:, e:e + 2 * want_ehh],
                               want[:, e:e + 2 * want_ehh], rtol=1e-5)
    for lo, hi, kw in ((lay["pi"], lay["fst"], dict(rtol=1e-5, atol=1e-6)),
                       (lay["fst"], lay["s"], dict(atol=2e-3))):
        g, w = got[:, lo:hi], want[:, lo:hi]
        ok = ~np.isnan(w)
        np.testing.assert_allclose(g[ok], w[ok], **kw)


def test_wire_unpack_inverts_pack():
    flat, (geno, member, smask, panels, lengths, _, _), _ = batch(1)
    g, m, sm, pn, ln, wt, fc = wire_unpack(on_cpu(flat), 128,
                                           128, 4)
    np.testing.assert_array_equal(g.numpy(), geno)
    np.testing.assert_array_equal(m.numpy(), member)
    np.testing.assert_array_equal(sm.numpy(), smask)
    np.testing.assert_array_equal(pn.numpy(), panels)
    np.testing.assert_array_equal(ln.numpy(), lengths.astype(np.float32))
    assert wt is None and fc is None


def test_wire_unpack_weights_and_focal():
    flat, (geno, _, _, _, _, wts, focals), _ = batch(
        5, use_weights=True, use_ehh=True)
    dev_flat = on_cpu(flat)
    g, _, _, _, _, wt, fc = wire_unpack(dev_flat, 128, 128, 4, True, True)
    np.testing.assert_array_equal(g.numpy(), geno)
    np.testing.assert_array_equal(wt.numpy(), wts)
    np.testing.assert_array_equal(fc.numpy(), focals.astype(np.int32))
    with pytest.raises(ValueError, match="layout wants"):
        wire_unpack(dev_flat, 128, 128, 4, True, False)


@pytest.mark.parametrize("disjoint,partial,p", [
    (True, False, 4), (False, False, 4), (True, True, 2), (True, False, 1)])
def test_scan_step_matches_jax(disjoint, partial, p):
    flat, _, pairs = batch(2, p=p, disjoint=disjoint, partial=partial)
    step = _scan_step(128, 128, p, pairs, THR, False, False, 512, True,
                      disjoint and bool(pairs), one_device())
    want = np.asarray(step(flat))
    got = scan_step(on_cpu(flat), 128, 128, p, pairs, THR,
                    disjoint and bool(pairs)).numpy()
    assert_rows(got, want, p, len(pairs))
    if partial:
        assert got[0, row_layout(p, len(pairs))["risk"]] == 1.0


@pytest.mark.parametrize("weights,ehh,afs,disjoint,folded", [
    (True, False, False, True, True), (False, True, False, True, True),
    (False, False, True, True, True), (False, False, True, True, False),
    (True, True, True, True, True), (True, True, True, False, False)])
def test_scan_step_options_match_jax(weights, ehh, afs, disjoint, folded):
    flat, _, pairs = batch(6, disjoint=disjoint, use_weights=weights,
                           use_ehh=ehh)
    step = _scan_step(128, 128, 4, pairs, THR, weights, afs, 60, folded,
                      disjoint, one_device(), ehh)
    want = np.asarray(step(flat))
    got = scan_step(on_cpu(flat), 128, 128, 4, pairs, THR,
                    disjoint, weights, ehh, afs, 60, folded).numpy()
    assert_rows(got, want, 4, len(pairs), ehh)


@pytest.mark.parametrize("ehh", [False, True])
def test_fstg_exact_weighted_step_matches_jax(ehh):
    """Column-mode weights reach the exact recompute; an --ehh wire row
    (4 bytes longer) decodes with the scan's layout flags."""
    flat, _, pairs = batch(7, disjoint=False, partial=True,
                           use_weights=True, use_ehh=ehh)
    step = _scan_step_fstg_exact(128, 128, 4, pairs, THR, True, one_device())
    want = np.asarray(step(flat))
    dev_flat = on_cpu(flat)
    got = scan_step_fstg_exact(dev_flat, 128, 128, 4, pairs, THR,
                               use_weights=True, use_ehh=ehh).numpy()
    np.testing.assert_allclose(got, want, atol=2e-3)
    assert got.shape == (3, len(pairs))
    with pytest.raises(ValueError, match="layout wants"):
        scan_step_fstg_exact(dev_flat, 128, 128, 4, pairs, THR,
                             use_weights=True, use_ehh=not ehh)


def test_fstg_exact_step_matches_jax():
    flat, _, pairs = batch(4, disjoint=False, partial=True)
    step = _scan_step_fstg_exact(128, 128, 4, pairs, THR, False,
                                 one_device())
    want = np.asarray(step(flat))
    got = scan_step_fstg_exact(on_cpu(flat), 128, 128, 4,
                               pairs, THR).numpy()
    np.testing.assert_allclose(got, want, atol=2e-3)
    rows = scan_step_fstg_exact(on_cpu(flat), 128, 128, 4,
                                pairs, THR, rows=[0, 2]).numpy()
    np.testing.assert_array_equal(rows, got[[0, 2]])
