"""The plain reference against values frozen from the repository's
pure-Python estimators (pica2 π, Hudson direct and grouped Fst, Tajima's
D) on a tiny pangenome of 12 haplotypes and 9 sites."""
import math

import numpy as np
import pytest

from benchmark import reference as ref

GENO = np.array([
    [0, 0, 0, 1, 1, 0, 0, 1, 1], [0, 0, 1, 0, 0, 0, 0, 0, 0],
    [0, 1, 0, 1, 0, 1, 0, 0, 1], [0, 1, 0, 1, 0, 1, 0, 0, 1],
    [0, 1, 1, 0, 0, 0, 1, 1, 0], [0, 0, 1, 1, 0, 1, 0, 0, 0],
    [0, 0, 0, 1, 0, 0, 0, 0, 1], [1, 0, 0, 1, 0, 0, 0, 0, 1],
    [0, 0, 0, 0, 0, 0, 0, 1, 0], [0, 0, 0, 0, 0, 1, 0, 1, 0],
    [0, 0, 0, 1, 0, 1, 0, 1, 0], [1, 0, 0, 1, 0, 1, 0, 0, 1]], np.int8)
# frozen from the pure-Python estimators (panel A rows 0-4, B rows 5-9,
# length 1000, threshold 0.9985, sims 1 - diff / length in float32)
PI_A, PI_B, PI_AB = 0.004399996995925904, 0.0026000142097473153, \
    0.00342222187254164
FST, FSTG = -0.05555494847183776, -0.0416699189091768
TAJD_A, TAJD_B = -7.106427061300733, -7.106430022286708


@pytest.fixture(scope="module")
def stats():
    masks = np.zeros((2, 12), bool)
    masks[0, :5] = True
    masks[1, 5:10] = True
    return ref.window_stats(GENO, masks, 1000, [(0, 1)], 0.9985)


def test_frozen_values(stats):
    assert stats["s"] == 9 and stats["n"] == 12
    np.testing.assert_allclose(stats["pi"], [PI_A, PI_B], rtol=1e-12)
    np.testing.assert_allclose(stats["fst"], [FST], rtol=1e-9)
    np.testing.assert_allclose(stats["fstg"], [FSTG], rtol=1e-9)
    np.testing.assert_allclose(stats["fst3"],
                               [(PI_AB - 0.5 * (PI_A + PI_B)) / PI_AB],
                               rtol=1e-9)
    np.testing.assert_allclose(stats["tajd"], [TAJD_A, TAJD_B], rtol=1e-12)


def test_tf32_control_moves_every_float(stats):
    masks = np.zeros((2, 12), bool)
    masks[0, :5] = True
    masks[1, 5:10] = True
    ctl = ref.window_stats(GENO, masks, 1000, [(0, 1)], 0.9985,
                           mantissa=10)
    for key in ("fst", "fstg", "tajd"):
        assert not np.allclose(ctl[key], stats[key], rtol=1e-7, atol=0)


def test_threshold_test_is_float32():
    # rows 6 and 7 differ at one site of 1000: sim is 0.999 in float32,
    # not above the float32 threshold 0.999, so they are two groups (the
    # Python-float estimators, comparing in float64, would join them)
    masks = np.zeros((1, 12), bool)
    masks[0, [6, 7]] = True
    out = ref.window_stats(GENO, masks, 1000, [], 0.999)
    assert out["pi"][0] > 0


def test_round_mantissa():
    assert ref.round_mantissa(1.0 + 2 ** -11, 10) == 1.0       # ties to even
    assert ref.round_mantissa(1.0 + 3 * 2 ** -11, 10) == 1.0 + 2 ** -9
    assert ref.round_mantissa(0.3, None) == 0.3


def test_ehh_areas_by_hand():
    # focal column 1: carriers of 0 are rows 0 and 2, of 1 rows 1 and 3
    g = np.array([[0, 0, 1, 1], [1, 1, 1, 0], [0, 0, 1, 0], [1, 1, 0, 0]],
                 np.int8)
    a0, a1, c0, c1 = ref.ehh_areas(g, 1)
    assert (c0, c1) == (2, 2)
    # rows 0, 2: left agree 1 step, right agree 1 step (col 2) then differ
    assert a0 == 2.0
    # rows 1, 3: left agree 1, right differ at once
    assert a1 == 1.0


def test_tajimas_d_nan_without_sites():
    assert math.isnan(ref.tajimas_d(10, 0, 0.0))
    assert math.isnan(ref.tajimas_d(1, 5, 0.1))


def test_panel_afs_folds():
    g = np.array([[1, 1, 0], [1, 0, 0], [0, 0, 0], [1, 0, 1]], np.int8)
    masks = np.ones((1, 4), bool)
    h = ref.panel_afs(g, masks, 4)
    # site 0: 3 of 4 -> minor 1; site 1: 1; site 2: 1
    assert h[0].tolist() == [0, 3, 0, 0, 0]
