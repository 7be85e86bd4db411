"""impop_tpu_torch.stats.{panelstats, fst, tajima} against the JAX package
(CPU backend) on the same numpy inputs.

Tolerances: integer outputs exact (n, num_groups, pairs_used, seed_risk);
π, diversities and Dxy rtol 1e-5 (float32 sums in another order); Fst
atol 2e-3 (the float32 cancellation budget of the reference); NaN at the
same places."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from impop_tpu.stats import fst as jfst
from impop_tpu.stats import panelstats as jps
from impop_tpu.stats import tajima as jtaj
from impop_tpu.stats.allele import identity_from_alleles as j_identity
from impop_tpu_torch.stats import fst as tfst
from impop_tpu_torch.stats import panelstats as tps
from impop_tpu_torch.stats import tajima as ttaj

torch.set_num_threads(1)
THR = 0.999
PAIR_A, PAIR_B = (0, 0, 1, 2), (1, 2, 3, 3)
FST_FIELDS = ("fst", "da")
DIV_FIELDS = ("pi_a", "pi_b", "pi_xy", "dxy")


def window(seed, n=128, s=128, disjoint=True, partial=False):
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, 6, size=n)
    base = rng.integers(0, 2, size=(6, s)).astype(np.int8)
    geno = base[cls]
    geno = np.where(rng.random((n, s)) < 0.01, 1 - geno, geno).astype(np.int8)
    geno[rng.random((n, s)) < 0.05] = -1
    if partial:
        geno[: n // 2, s // 2:] = -1
        geno[n // 2:, : s // 2] = -1
    member = np.ones(n, bool)
    member[-9:] = False
    geno[-9:] = -1
    smask = np.ones(s, bool)
    if disjoint:
        pmasks = np.zeros((4, n), bool)
        edges = np.linspace(0, n - 9, 5).astype(int)
        for i in range(4):
            pmasks[i, edges[i]:edges[i + 1]] = True
    else:
        pmasks = rng.random((4, n)) < 0.5
    sim, present = j_identity(jnp.asarray(geno), jnp.asarray(member),
                              jnp.asarray(smask), jnp.float32(5000.0))
    return np.array(sim), np.array(present), member, pmasks


def assert_fst(got, want, tag):
    for f in DIV_FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-5,
                                   atol=1e-9, err_msg=f"{tag}.{f}")
    for f in FST_FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), atol=2e-3,
                                   err_msg=f"{tag}.{f}")


def assert_panelstats(got, want):
    np.testing.assert_allclose(got.pi.numpy(), np.asarray(want.pi),
                               rtol=1e-5, atol=1e-9)
    for f in ("n", "num_groups", "pairs_used", "pairs_missing"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert_fst(got.hudson, want.hudson, "hudson")
    assert_fst(got.hudson_grouped, want.hudson_grouped, "hudson_grouped")
    assert bool(got.seed_risk) == bool(want.seed_risk)


@pytest.mark.parametrize("disjoint,partial", [
    (True, False), (False, False), (True, True)])
def test_fused_panel_stats_matches_jax(disjoint, partial):
    sim, present, member, pmasks = window(11, disjoint=disjoint,
                                          partial=partial)
    want = jps.fused_panel_stats(
        jnp.asarray(sim), jnp.asarray(present), jnp.asarray(member),
        jnp.asarray(pmasks), jnp.asarray(PAIR_A), jnp.asarray(PAIR_B),
        jnp.float32(THR), pairs_disjoint=disjoint)
    got = tps.fused_panel_stats(
        torch.from_numpy(sim), torch.from_numpy(present),
        torch.from_numpy(member), torch.from_numpy(pmasks), PAIR_A, PAIR_B,
        THR, pairs_disjoint=disjoint)
    assert_panelstats(got, want)
    if partial:
        assert bool(got.seed_risk), "fixture must trip seed_risk"


@pytest.mark.parametrize("disjoint", [True, False])
def test_assemble_from_kernel_matches_jax(disjoint):
    """The epilogue on the same raw row-dots gives the same PanelStats."""
    rng = np.random.default_rng(3)
    p, q = 4, len(PAIR_A)
    pq = p + q
    r = pq if disjoint else pq + 2 * q
    raw = {"quad": rng.random(r) * 40, "n": rng.integers(0, 60, r),
           "num_groups": rng.integers(0, 9, r),
           "pairs_used2": 2 * rng.integers(0, 30, pq),
           "gdxy": rng.random(q) * 3, "seed_risk": np.float32(1.0)}
    for k in ("aa", "bb", "ab"):
        raw[f"sum_{k}"] = rng.random(q) * 50
        raw[f"cnt_{k}"] = rng.integers(0, 400, q).astype(float)
    raw["cnt_ab"][0] = 0.0          # an empty cross count
    raw = {k: np.asarray(v, np.float32) for k, v in raw.items()}
    want = jps._assemble_from_kernel(
        {k: jnp.asarray(v) for k, v in raw.items()}, pq, q, PAIR_A, PAIR_B,
        disjoint)
    got = tps._assemble_from_kernel(
        {k: torch.from_numpy(v) for k, v in raw.items()}, pq, q, PAIR_A,
        PAIR_B, disjoint)
    assert_panelstats(got, want)


@pytest.mark.parametrize("seed,partial", [(21, False), (22, True)])
def test_hudson_fst_grouped_pairs_matches_jax(seed, partial):
    sim, present, member, pmasks = window(seed, disjoint=False,
                                          partial=partial)
    ma = pmasks[list(PAIR_A)] & member
    mb = pmasks[list(PAIR_B)] & member
    ov = ma & mb
    ma, mb = ma & ~ov, mb & ~ov
    want = jfst.hudson_fst_grouped_pairs(
        jnp.asarray(sim), jnp.asarray(present), jnp.asarray(ma),
        jnp.asarray(mb), jnp.float32(THR))
    got = tfst.hudson_fst_grouped_pairs(
        torch.from_numpy(sim), torch.from_numpy(present),
        torch.from_numpy(ma), torch.from_numpy(mb), THR)
    assert_fst(got, want, "grouped_pairs")


def test_tajimas_d_matches_jax():
    n = np.array([0, 1, 2, 3, 10, 33, 34, 60, 140, 466, 466, 40],
                 np.float32)
    s = np.array([5, 5, 5, 0, 7, 20, 21, 83, 100, 1, 128, 9], np.float32)
    pi = np.array([0.1, 1, 2, 0, 3.5, 4, 9, 20, 18, 0.5, 40, 0.0],
                  np.float32)
    want = np.asarray(jtaj.tajimas_d(jnp.asarray(n), jnp.asarray(s),
                                     jnp.asarray(pi)))
    got = ttaj.tajimas_d(torch.from_numpy(n), torch.from_numpy(s),
                         torch.from_numpy(pi)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    for f in ttaj.TajimaConstants._fields:
        np.testing.assert_allclose(
            getattr(ttaj.tajima_constants(torch.from_numpy(n[4:])), f),
            np.asarray(getattr(jtaj.tajima_constants(jnp.asarray(n[4:])),
                               f)), rtol=1e-6, err_msg=f)


def guard_window():
    """The inputs of tests/test_panelstats.py's guard test: 4 members, two
    panels of two, sim 0.5 off the diagonal (every member its own seed),
    and present with the (0, 2) cross pair knocked out."""
    n = 16
    member = np.zeros(n, bool)
    member[:4] = True
    pmasks = np.zeros((2, n), bool)
    pmasks[0, :2] = True
    pmasks[1, 2:4] = True
    sim = np.full((n, n), 0.5, np.float32)
    np.fill_diagonal(sim, 1.0)
    present_ok = np.ones((n, n), bool)
    present_bad = present_ok.copy()
    present_bad[0, 2] = present_bad[2, 0] = False
    return sim, present_ok, present_bad, member, pmasks


def warned_count(record) -> list:
    import re

    return [int(re.search(r"(\d+) group-seed pair", str(w.message)).group(1))
            for w in record if issubclass(w.category, RuntimeWarning)
            and "group-seed pair" in str(w.message)]


def test_seed_pair_guard_warns_where_jax_does(monkeypatch):
    """IMPOP_TPU_DEBUG_INVARIANTS: silent when every seed pair has data, a
    RuntimeWarning for disjoint and for overlapping pairs when one lacks
    data, with the JAX guard's count."""
    import warnings

    monkeypatch.setattr(tps, "DEBUG_SEED_INVARIANT", True)
    monkeypatch.setattr(jps, "DEBUG_SEED_INVARIANT", True)
    sim, ok, bad, member, pmasks = guard_window()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tps.fused_panel_stats(torch.from_numpy(sim), torch.from_numpy(ok),
                              torch.from_numpy(member),
                              torch.from_numpy(pmasks), (0,), (1,), 0.999,
                              pairs_disjoint=True)
    for disjoint in (True, False):
        with pytest.warns(RuntimeWarning, match="group-seed pair") as got:
            tps.fused_panel_stats(
                torch.from_numpy(sim), torch.from_numpy(bad),
                torch.from_numpy(member), torch.from_numpy(pmasks), (0,),
                (1,), 0.999, pairs_disjoint=disjoint)
        with pytest.warns(RuntimeWarning, match="group-seed pair") as want:
            jps.fused_panel_stats(
                jnp.asarray(sim), jnp.asarray(bad), jnp.asarray(member),
                jnp.asarray(pmasks), jnp.asarray([0], jnp.int32),
                jnp.asarray([1], jnp.int32), jnp.float32(0.999),
                pairs_disjoint=disjoint)
        assert warned_count(got) == warned_count(want) == [1], disjoint


def test_seed_pair_guard_is_not_called_when_off(monkeypatch):
    """With the flag off, fused_panel_stats never reaches the guard."""
    def fail(*args):
        raise AssertionError("the guard ran with the flag off")

    monkeypatch.setattr(tps, "DEBUG_SEED_INVARIANT", False)
    monkeypatch.setattr(tps, "_seed_pair_guard", fail)
    sim, _, bad, member, pmasks = guard_window()
    for disjoint in (True, False):
        tps.fused_panel_stats(torch.from_numpy(sim), torch.from_numpy(bad),
                              torch.from_numpy(member),
                              torch.from_numpy(pmasks), (0,), (1,), 0.999,
                              pairs_disjoint=disjoint)
