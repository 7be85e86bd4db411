"""The per-statistic estimators of impop_tpu_torch against the JAX package
(CPU backend) on the same numpy inputs: ``direct_diversity`` (within and
between), ``pi_grouped_panels``, ``grouped_diversity``, the four Hudson
estimators, ``fst_3pi``, ``label_components``, ``allele_window_stats``,
the batch functions of ``parallel/scan``, ``build_window_batch``, the tile
builders of ``stats/types`` and the names of ``stats/api``.

Tolerances: gid, n, num_groups, pairs_used, pairs_missing, counts and
labels exact; π, Dxy and the diversity means rtol 1e-5 (float32 sums in
another order); Fst atol 2e-3; NaN at the same places."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from impop_tpu.io.simtsv import SimilarityMatrix
from impop_tpu.parallel import scan as jscan
from impop_tpu.runtime.batcher import PanelSet as JPanelSet
from impop_tpu.runtime.batcher import build_window_batch as j_build
from impop_tpu.stats import allele as jallele
from impop_tpu.stats import api as japi
from impop_tpu.stats import diversity as jdiv
from impop_tpu.stats import fst as jfst
from impop_tpu.stats import grouping as jg
from impop_tpu.stats import pi as jpi
from impop_tpu.stats import types as jtypes
from impop_tpu_torch.parallel import scan as tscan
from impop_tpu_torch.runtime.batcher import PanelSet, build_window_batch
from impop_tpu_torch.stats import allele as tallele
from impop_tpu_torch.stats import api as tapi
from impop_tpu_torch.stats import diversity as tdiv
from impop_tpu_torch.stats import fst as tfst
from impop_tpu_torch.stats import grouping as tg
from impop_tpu_torch.stats import pi as tpi
from impop_tpu_torch.stats import types as ttypes

torch.set_num_threads(1)
THR = 0.999
INT_FIELDS = ("n", "num_groups", "pairs_used", "pairs_missing")


def sims(seed, w, n, missing=0.05):
    """W clustered similarity windows padded to N: classes at 0.9995,
    others at 0.995, symmetric noise, 5-decimal values, missing pairs."""
    rng = np.random.default_rng(seed)
    sim = np.zeros((w, n, n), np.float32)
    pres = np.zeros((w, n, n), bool)
    member = np.zeros((w, n), bool)
    for wi in range(w):
        m = n - int(rng.integers(0, 8))
        cls = rng.integers(0, 6, size=m)
        base = np.where(cls[:, None] == cls[None, :], 0.9995, 0.995)
        noise = rng.normal(0.0, 0.0004, size=(m, m))
        s = np.round(np.clip(base + (noise + noise.T) / 2, 0.0, 1.0), 5)
        p = rng.random((m, m)) > missing
        p = p & p.T
        np.fill_diagonal(p, True)
        np.fill_diagonal(s, 1.0)
        sim[wi, :m, :m] = np.where(p, s, 0.0)
        pres[wi, :m, :m] = p
        member[wi, :m] = True
    return sim, pres, member


def masks(seed, w, p, n, member, prob=0.5):
    rng = np.random.default_rng(seed + 100)
    return (rng.random((w, p, n)) < prob) & member[:, None, :]


def disjoint_pair(seed, member):
    """Two disjoint masks [W, N] over the members."""
    rng = np.random.default_rng(seed + 200)
    side = rng.integers(0, 3, size=member.shape)
    return (side == 0) & member, (side == 1) & member


def t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def close(got, want, rtol=1e-5, atol=1e-7):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


def assert_fst(got, want):
    """FstResult: π, Dxy rtol 1e-5; Fst and Da atol 2e-3."""
    for f in ("pi_a", "pi_b", "pi_xy", "dxy"):
        close(getattr(got, f).numpy(), getattr(want, f), atol=1e-8)
    for f in ("fst", "da"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=2e-3)


def assert_pi(got, want):
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    close(got.pi.numpy(), want.pi, atol=1e-8)


# ------------------------------------------------------------ diversity


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("between", [False, True])
def test_direct_diversity_matches_jax(seed, between):
    sim, pres, member = sims(seed, 1, 64, missing=0.1)
    ma, mb = disjoint_pair(seed, member)
    jargs = j(sim[0], pres[0], ma[0]) + (j(mb[0]) if between else [])
    want = jdiv.direct_diversity(*jargs)
    targs = t(sim[0], pres[0], ma[0]) + (t(mb[0]) if between else [])
    got = tdiv.direct_diversity(*targs)
    assert int(got.count) == int(want.count) > 0
    assert int(got.missing) == int(want.missing) > 0
    close(float(got.mean), float(want.mean))
    # a leading window axis gives the same numbers window by window
    tb = t(sim, pres, ma) + (t(mb) if between else [])
    batched = tdiv.direct_diversity(*tb)
    assert int(batched.count[0]) == int(got.count)
    close(float(batched.mean[0]), float(got.mean))


# ------------------------------------------------------------ pi


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pi_grouped_panels_matches_jax(seed):
    sim, pres, member = sims(seed, 1, 64)
    pm = masks(seed, 1, 4, 64, member)
    pm[0, 3] = False                       # an empty panel: pi 0, n 0
    want = jpi.pi_grouped_panels(*j(sim[0], pres[0], member[0], pm[0]), THR)
    got = tpi.pi_grouped_panels(*t(sim[0], pres[0], member[0], pm[0]), THR)
    assert_pi(got, want)
    assert int(got.num_groups[:3].min()) > 1
    # each panel equals pi_grouped on its own mask
    for p in range(3):
        one = tpi.pi_grouped(*t(sim[0], pres[0], pm[0, p]), THR)
        assert int(one.num_groups) == int(got.num_groups[p])
        close(float(one.pi), float(got.pi[p]))


@pytest.mark.parametrize("seed", [3, 4])
def test_grouped_diversity_matches_jax(seed):
    sim, pres, member = sims(seed, 2, 48, missing=0.15)
    for wi in range(2):
        want = jpi.grouped_diversity(*j(sim[wi], pres[wi], member[wi]), THR)
        got = tpi.grouped_diversity(*t(sim[wi], pres[wi], member[wi]), THR)
        assert_pi(got, want)
        assert int(got.pairs_missing) >= 0 and int(got.num_groups) > 1
    batched = tpi.grouped_diversity(*t(sim, pres, member), THR)
    close(batched.pi.numpy()[1], float(got.pi))


# ------------------------------------------------------------ fst


@pytest.mark.parametrize("seed", [0, 1])
def test_hudson_fst_direct_matches_jax(seed):
    sim, pres, member = sims(seed, 1, 64, missing=0.1)
    ma, mb = disjoint_pair(seed, member)
    want = jfst.hudson_fst_direct(*j(sim[0], pres[0], ma[0], mb[0]))
    got = tfst.hudson_fst_direct(*t(sim[0], pres[0], ma[0], mb[0]))
    assert_fst(got, want)
    assert float(got.dxy) > 0


@pytest.mark.parametrize("seed", [2, 3])
def test_hudson_fst_direct_pairs_matches_jax(seed):
    sim, pres, member = sims(seed, 1, 64)
    pm = masks(seed, 1, 6, 64, member)
    ma, mb = pm[0, :3], pm[0, 3:]
    ov = ma & mb
    ma, mb = ma & ~ov, mb & ~ov
    want = jfst.hudson_fst_direct_pairs(*j(sim[0], pres[0], ma, mb))
    got = tfst.hudson_fst_direct_pairs(*t(sim[0], pres[0], ma, mb))
    assert_fst(got, want)
    # pair by pair, the single-pair estimator
    for q in range(3):
        one = tfst.hudson_fst_direct(*t(sim[0], pres[0], ma[q], mb[q]))
        close(float(one.dxy), float(got.dxy[q]))


@pytest.mark.parametrize("seed", [4, 5])
def test_hudson_fst_grouped_matches_jax(seed):
    sim, pres, member = sims(seed, 1, 48, missing=0.1)
    ma, mb = disjoint_pair(seed, member)
    want = jfst.hudson_fst_grouped(*j(sim[0], pres[0], ma[0], mb[0]), THR)
    got = tfst.hudson_fst_grouped(*t(sim[0], pres[0], ma[0], mb[0]), THR)
    assert_fst(got, want)
    assert float(got.dxy) > 0


@pytest.mark.parametrize("seed", [6, 7])
def test_hudson_fst_grouped_pairs_matches_vmapped_grouped(seed):
    """The pairs estimator over a window axis against the JAX vmap of
    hudson_fst_grouped over pairs, window by window."""
    w, n, q = 2, 48, 3
    sim, pres, member = sims(seed, w, n, missing=0.1)
    pm = masks(seed, w, 2 * q, n, member)
    ma, mb = pm[:, :q], pm[:, q:]
    ov = ma & mb
    ma, mb = ma & ~ov, mb & ~ov
    got = tfst.hudson_fst_grouped_pairs(*t(sim, pres, ma, mb), THR)
    vmapped = jax.vmap(jfst.hudson_fst_grouped,
                       in_axes=(None, None, 0, 0, None))
    for wi in range(w):
        want = vmapped(*j(sim[wi], pres[wi], ma[wi], mb[wi]), THR)
        assert_fst(type(got)(*(f[wi] for f in got)), want)


def test_fst_3pi_matches_jax():
    pa = np.array([0.001, 0.002, 0.0, 0.003], np.float32)
    pb = np.array([0.002, 0.001, 0.0, 0.001], np.float32)
    pc = np.array([0.004, 0.0, 0.0, 0.0025], np.float32)
    want = np.asarray(jfst.fst_3pi(*j(pa, pb, pc)))
    got = tfst.fst_3pi(*t(pa, pb, pc)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[1]) and np.isnan(got[2])
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-6)


# ------------------------------------------------------------ grouping


@pytest.mark.parametrize("seed,thr", [(0, 0.999), (1, 0.9995), (2, 1.0)])
def test_label_components_matches_jax(seed, thr):
    sim, pres, member = sims(seed, 2, 64, missing=0.3)
    adj = (sim >= np.float32(thr)) & pres
    got = tg.label_components(*t(adj, member)).numpy()
    for wi in range(2):
        want = np.asarray(jg.label_components(*j(adj[wi], member[wi])))
        np.testing.assert_array_equal(got[wi], want)
    assert len(set(got[0][member[0]].tolist())) > 1


# ------------------------------------------------------------ allele


@pytest.mark.parametrize("num_alleles", [2, 3])
def test_allele_window_stats_matches_jax(num_alleles):
    rng = np.random.default_rng(num_alleles)
    w, n, s = 3, 40, 96
    geno = rng.integers(0, num_alleles, size=(w, n, s)).astype(np.int8)
    geno[rng.random(geno.shape) < 0.05] = -1
    member = np.ones((w, n), bool)
    member[:, -4:] = False
    smask = np.ones((w, s), bool)
    smask[:, -9:] = False
    got = tscan.batch_allele_stats(*t(geno, member, smask), 64, num_alleles)
    want = jscan.batch_allele_stats(*j(geno, member, smask), max_n=64,
                                    num_alleles=num_alleles)
    np.testing.assert_array_equal(got.s.numpy(), np.asarray(want.s))
    np.testing.assert_array_equal(got.n.numpy(), np.asarray(want.n))
    np.testing.assert_array_equal(got.afs.numpy(), np.asarray(want.afs))
    close(got.pi_direct.numpy(), want.pi_direct)
    one = tallele.allele_window_stats(*t(geno[1], member[1], smask[1]), 64,
                                      num_alleles)
    want1 = jallele.allele_window_stats(*j(geno[1], member[1], smask[1]), 64,
                                        num_alleles)
    close(float(one.pi_direct), float(want1.pi_direct))


# ------------------------------------------------------------ batches


def test_batch_pi_panels_matches_jax():
    sim, pres, member = sims(8, 3, 64)
    pm = masks(8, 3, 3, 64, member)
    want = jscan.batch_pi_panels(*j(sim, pres, member, pm), THR)
    got = tscan.batch_pi_panels(*t(sim, pres, member, pm), THR)
    assert_pi(got, want)
    assert got.pi.shape == (3, 3)


@pytest.mark.parametrize("with_grouped", [False, True])
def test_batch_hudson_matches_jax(with_grouped, monkeypatch):
    """Overlapping panels (stripped per pair), three pairs; the grouped
    method in window chunks of one."""
    monkeypatch.setattr(tscan, "_HUDSON_CHUNK_ELEMS", 1)
    sim, pres, member = sims(9, 3, 48, missing=0.1)
    pm = masks(9, 3, 3, 48, member, prob=0.45)
    pa, pb = (0, 0, 1), (1, 2, 2)
    want = jscan.batch_hudson(*j(sim, pres, member, pm),
                              jnp.asarray(pa, jnp.int32),
                              jnp.asarray(pb, jnp.int32), THR,
                              with_grouped=with_grouped)
    got = tscan.batch_hudson(*t(sim, pres, member, pm), pa, pb, THR,
                             with_grouped=with_grouped)
    assert_fst(got.direct, want.direct)
    assert_fst(got.grouped, want.grouped)
    assert got.grouped.fst.shape == (3, 3)


def test_batch_fst_3pi_panels_matches_jax():
    sim, pres, member = sims(10, 3, 64)
    pm = masks(10, 3, 3, 64, member, prob=0.4)
    pm[2, 1] = False                       # πC may vanish with an empty side
    pa, pb = (0, 0, 1), (1, 2, 2)
    want = jscan.batch_fst_3pi_panels(*j(sim, pres, member, pm),
                                      jnp.asarray(pa, jnp.int32),
                                      jnp.asarray(pb, jnp.int32), THR)
    got = tscan.batch_fst_3pi_panels(*t(sim, pres, member, pm), pa, pb, THR)
    for f in ("pi_a", "pi_b", "pi_c", "pi_ab"):
        close(getattr(got, f).numpy(), getattr(want, f), atol=1e-8)
    fw, fg = np.asarray(want.fst), got.fst.numpy()
    np.testing.assert_array_equal(np.isnan(fg), np.isnan(fw))
    ok = ~np.isnan(fw)
    np.testing.assert_allclose(fg[ok], fw[ok], rtol=0, atol=2e-3)


# ------------------------------------------------------------ batcher


def matrices(seed, sizes):
    """SimilarityMatrix windows with HPRC-style names HG0000k#h#ctg."""
    rng = np.random.default_rng(seed)
    mats = []
    for n in sizes:
        names = sorted(f"HG{i // 2:05d}#{i % 2 + 1}#ctg{i}" for i in range(n))
        s = np.round(rng.uniform(0.99, 1.0, size=(n, n)), 4)
        s = (s + s.T) / 2
        np.fill_diagonal(s, 1.0)
        mats.append(SimilarityMatrix(names=names, sim=s,
                                     present=np.ones((n, n), bool),
                                     pair_count=n * (n - 1) // 2))
    return mats


@pytest.mark.parametrize("exact", [False, True])
def test_build_window_batch_matches_jax(exact):
    mats = matrices(11, [10, 14, 7])
    if exact:
        panels = {"A": ("HG00001#1#ctg2", "HG00003#2#ctg7", "nope"),
                  "B": ("HG00000#2#ctg1", "HG00004#1#ctg8")}
    else:
        panels = {"A": ("HG00001", "HG00003_hap2_hprc_r2"),
                  "B": ("HG00000", "HG00004_hap1", "HG00099")}
    want, names_j = j_build(mats, JPanelSet.from_dict(panels), capacity=64,
                            batch_pad=4, exact_names=exact)
    got, names_t = build_window_batch(mats, PanelSet.from_dict(panels),
                                      capacity=64, batch_pad=4,
                                      exact_names=exact, device="cpu")
    assert names_t == names_j
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got.panels.shape == (4, 2, 64) and bool(got.panels.any())
    with pytest.raises(ValueError):
        build_window_batch(mats, None, capacity=8)


def test_sim_tiles_and_api_names_match_jax():
    """stats/types builders and the stats/api names on one window."""
    mat = matrices(12, [12])[0]
    tile = ttypes.sim_tile_from_matrix(mat, 64, device="cpu")
    jtile = jtypes.sim_tile_from_matrix(mat, 64)
    for a, b in zip(tile, jtile):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tile.capacity == 64
    ma = ttypes.mask_from_names(mat, mat.names[:5], 64, device="cpu")
    mb = ttypes.mask_from_names(mat, mat.names[5:], 64, device="cpu")
    np.testing.assert_array_equal(
        ma.numpy(), np.asarray(jtypes.mask_from_names(mat, mat.names[:5],
                                                      64)))
    jt, jma, jmb = tuple(jtile), jnp.asarray(ma.numpy()), jnp.asarray(
        mb.numpy())
    assert_pi(tapi.pi_grouped_jit(*tile, THR), japi.pi_grouped_jit(*jt, THR))
    assert_pi(tapi.grouped_diversity_jit(*tile, THR),
              japi.grouped_diversity_jit(*jt, THR))
    for args_t, args_j in (((ma,), (jma,)), ((ma, mb), (jma, jmb))):
        got = tapi.direct_diversity_jit(tile.sim, tile.present, *args_t)
        want = japi.direct_diversity_jit(jtile.sim, jtile.present, *args_j)
        assert int(got.count) == int(want.count)
        close(float(got.mean), float(want.mean))
    assert_fst(tapi.hudson_fst_direct_jit(tile.sim, tile.present, ma, mb),
               japi.hudson_fst_direct_jit(jtile.sim, jtile.present, jma,
                                          jmb))
    assert_fst(tapi.hudson_fst_grouped_jit(tile.sim, tile.present, ma, mb,
                                           0.995),
               japi.hudson_fst_grouped_jit(jtile.sim, jtile.present, jma,
                                           jmb, 0.995))
    close(float(tapi.tajimas_d_jit(20.0, 7.0, 2.5)),
          float(japi.tajimas_d_jit(20.0, 7.0, 2.5)))
    assert np.isnan(float(tapi.fst_3pi_jit(0.1, 0.2, 0.0)))
    close(float(tapi.fst_3pi_jit(0.1, 0.2, 0.3)),
          float(japi.fst_3pi_jit(0.1, 0.2, 0.3)))
    with pytest.raises(ValueError):
        ttypes.pad_tile(np.ones((3, 3)), np.ones((3, 3), bool), 2)
