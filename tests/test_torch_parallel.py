"""The port's multi-device layer (``impop_tpu_torch.parallel``) against the
JAX package's on the same seeded numpy inputs.

JAX runs on the 8 virtual CPU devices that ``conftest.py`` forces; the
port runs on a grid of ``[cpu] x k`` (a mesh may repeat a device, so every
split, pad, gather and reduction runs here).  Compared:

- ``shard_batch`` + ``batch_over`` of ``batch_pi_panels`` / ``batch_hudson``
  / ``batch_fst_3pi_panels`` at data = 1, 2, 8 against
  ``impop_tpu.parallel.scan`` on ``make_mesh(data=k)`` (7 windows, so the
  port pads the last shard; JAX gets the batch padded to 8);
- ``site_sharded_window_stats`` at (1, 1) and (2, 4) against
  ``impop_tpu.parallel.longwindow``;
- ``pair_sharded_direct_stats`` at 2, 4 and 8 against
  ``impop_tpu.parallel.pairspace`` and against the replicated
  ``hudson_fst_direct_pairs``; a batch of windows of different N and S
  in one call at 1, 2 and 4 against single-window calls (S exact, sums
  rtol 1e-6) and the JAX function per window;
- ``host_window_range`` over the partition grid of
  ``tests/test_distributed.py``;
- ``dryrun_multidevice`` on grids of 2 and 8 entries: every path above
  and the scan's batches dealt over the ``data`` entries against one
  device.

Tolerances: integers exact (S, n, num_groups, pairs, AFS bins, EHH
carriers), π / Dxy / EHH areas rtol 1e-5, Fst and D atol 2e-3; one device
against several of the port: equal.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from impop_tpu.parallel import longwindow as jlong
from impop_tpu.parallel import mesh as jmesh
from impop_tpu.parallel import pairspace as jpair
from impop_tpu.parallel import scan as jscan
from impop_tpu.parallel.distributed import host_window_range as j_range
from impop_tpu_torch.parallel import mesh as tmesh
from impop_tpu_torch.parallel import scan as tscan
from impop_tpu_torch.parallel.distributed import host_window_range
from impop_tpu_torch.parallel.dryrun import dryrun_multidevice
from impop_tpu_torch.parallel.longwindow import site_sharded_window_stats
from impop_tpu_torch.parallel.pairspace import pair_sharded_direct_stats
from impop_tpu_torch.stats.allele import (identity_from_alleles,
                                          segregating_sites)
from impop_tpu_torch.stats.fst import hudson_fst_direct_pairs
from impop_tpu_torch.stats.panelstats import take

torch.set_num_threads(1)
THR = 0.999
CPU = torch.device("cpu")
RTOL, FST_ATOL = 1e-5, 2e-3


def cpus(k):
    return [CPU] * k


def close(got, want, kind):
    """kind: 'int' exact, 'pi' rtol 1e-5, 'fst' atol 2e-3 (NaN alike)."""
    got = np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    if kind == "int":
        np.testing.assert_array_equal(got, want)
    elif kind == "pi":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=FST_ATOL)


def sim_windows(seed, w=7, n=32, p=3):
    """Clustered similarity windows with missing pairs and padding rows;
    three overlapping panels."""
    rng = np.random.default_rng(seed)
    sim = np.zeros((w, n, n), np.float32)
    pres = np.zeros((w, n, n), bool)
    member = np.zeros((w, n), bool)
    for wi in range(w):
        m = n - int(rng.integers(0, 5))
        cls = rng.integers(0, 5, size=m)
        base = np.where(cls[:, None] == cls[None, :], 0.9995, 0.995)
        noise = rng.normal(0.0, 0.0004, size=(m, m))
        s = np.round(np.clip(base + (noise + noise.T) / 2, 0.0, 1.0), 5)
        pr = rng.random((m, m)) > 0.05
        pr = pr & pr.T
        np.fill_diagonal(pr, True)
        np.fill_diagonal(s, 1.0)
        sim[wi, :m, :m] = np.where(pr, s, 0.0)
        pres[wi, :m, :m] = pr
        member[wi, :m] = True
    panels = (rng.random((w, p, n)) < 0.5) & member[:, None, :]
    return sim, pres, member, panels


def jax_batch(arrays, pad_to=8):
    """The JAX batch padded with empty windows to ``pad_to``."""
    out = []
    for a in arrays:
        pad = np.zeros((pad_to - a.shape[0],) + a.shape[1:], a.dtype)
        out.append(jnp.asarray(np.concatenate([a, pad])))
    return jscan.WindowBatch(*out)


PAIRS = ((0, 0, 1), (1, 2, 2))


@pytest.mark.parametrize("data", [1, 2, 8])
@pytest.mark.parametrize("estimator", ["pi", "hudson", "fst3pi"])
def test_shard_batch_matches_jax(data, estimator):
    arrays = sim_windows(data)
    w = arrays[0].shape[0]
    batch = tscan.WindowBatch(*(torch.from_numpy(a) for a in arrays))
    mesh = tmesh.make_mesh(data=data, devices=cpus(data))
    shards = tscan.shard_batch(batch, mesh)
    assert len(shards) == data
    assert sum(s.sim.shape[0] for s in shards) == -(-w // data) * data
    jb = jscan.shard_batch(jax_batch(arrays),
                           jmesh.make_mesh(data=data))
    if estimator == "pi":
        got = tscan.batch_over(tscan.batch_pi_panels, batch, mesh, THR)
        want = jscan.batch_pi_panels(*jb, THR)
        close(got.pi, want.pi[:w], "pi")
        for f in ("n", "num_groups", "pairs_used", "pairs_missing"):
            close(getattr(got, f), getattr(want, f)[:w], "int")
        one = tscan.batch_pi_panels(*batch, THR)
    elif estimator == "hudson":
        got = tscan.batch_over(tscan.batch_hudson, batch, mesh, *PAIRS, THR)
        want = jscan.batch_hudson(*jb, jnp.asarray(PAIRS[0], jnp.int32),
                                  jnp.asarray(PAIRS[1], jnp.int32), THR)
        for kind in ("direct", "grouped"):
            g, r = getattr(got, kind), getattr(want, kind)
            for f in ("pi_a", "pi_b", "dxy"):
                close(getattr(g, f), getattr(r, f)[:w], "pi")
            close(g.fst, r.fst[:w], "fst")
        one = tscan.batch_hudson(*batch, *PAIRS, THR)
    else:
        got = tscan.batch_over(tscan.batch_fst_3pi_panels, batch, mesh,
                               *PAIRS, THR)
        want = jscan.batch_fst_3pi_panels(
            *jb, jnp.asarray(PAIRS[0], jnp.int32),
            jnp.asarray(PAIRS[1], jnp.int32), THR)
        for f in ("pi_a", "pi_b", "pi_c"):
            close(getattr(got, f), getattr(want, f)[:w], "pi")
        np.testing.assert_array_equal(np.isnan(got.fst.numpy()),
                                      np.isnan(np.asarray(want.fst)[:w]))
        close(np.nan_to_num(got.fst.numpy()),
              np.nan_to_num(np.asarray(want.fst)[:w]), "fst")
        one = tscan.batch_fst_3pi_panels(*batch, *PAIRS, THR)
    # the split batch is the one-device batch, field by field
    for a, b in zip(jax.tree_util.tree_leaves(tuple(got)),
                    jax.tree_util.tree_leaves(tuple(one))):
        assert torch.equal(a.nan_to_num(9.0), b.nan_to_num(9.0))


def long_windows(seed, w=8, n=24, s=64):
    rng = np.random.default_rng(seed)
    geno = rng.integers(0, 2, size=(w, n, s)).astype(np.int8)
    geno[rng.random((w, n, s)) < 0.05] = -1
    member = np.ones((w, n), bool)
    member[:, n - 3:] = False
    member[2, 5:] = False                 # a window with 5 members
    site_mask = np.ones((w, s), bool)
    site_mask[:, s - 6:] = False
    lengths = np.full(w, 1000.0, np.float32)
    lengths[3] = 0.0                      # clamps to 1
    return geno, member, site_mask, lengths


@pytest.mark.parametrize("data,site", [(1, 1), (2, 4)])
def test_site_sharded_matches_jax(data, site):
    args = long_windows(data * 10 + site)
    mesh = tmesh.make_mesh(data=data, site=site, devices=cpus(data * site))
    pi, s_count, d = site_sharded_window_stats(mesh, 24)(*args, THR)
    jm = jmesh.make_mesh(data=data, site=site)
    with jm:
        jpi, js, jd = jlong.site_sharded_window_stats(jm, max_n=24)(
            *args, THR)
    close(s_count, js, "int")
    close(pi, jpi, "pi")
    np.testing.assert_array_equal(np.isnan(d.numpy()), np.isnan(jd))
    close(np.nan_to_num(d.numpy()), np.nan_to_num(np.asarray(jd)), "fst")
    # against one device of the port: the site partials are integer
    # counts, so the sums are exact
    one = site_sharded_window_stats(tmesh.make_mesh(data=1, site=1,
                                                    devices=cpus(1)), 24)
    for a, b in zip((pi, s_count, d), one(*args, THR)):
        assert torch.equal(a.nan_to_num(9.0), b.nan_to_num(9.0))


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_pair_sharded_matches_jax(n_dev):
    rng = np.random.default_rng(n_dev)
    n, s, q = 64, 96, 3
    geno = rng.integers(0, 2, size=(n, s)).astype(np.int8)
    geno[rng.random((n, s)) < 0.1] = -1
    member = np.ones(n, bool)
    member[-5:] = False
    site_mask = np.ones(s, bool)
    site_mask[-7:] = False
    masks_a = np.zeros((q, n), bool)
    masks_b = np.zeros((q, n), bool)
    for qi in range(q):
        perm = rng.permutation(n)
        masks_a[qi, perm[:20]] = True
        masks_b[qi, perm[20:45]] = True
    masks_a &= member[None, :]
    masks_b &= member[None, :]
    length = 5000.0

    mesh = tmesh.make_mesh(data=n_dev, devices=cpus(n_dev))
    got = pair_sharded_direct_stats(mesh, axis="data")(
        geno, member, site_mask, masks_a, masks_b, length)
    jfn = jpair.pair_sharded_direct_stats(jmesh.make_mesh(data=n_dev),
                                          axis="data")
    want = jfn(jnp.asarray(geno), jnp.asarray(member),
               jnp.asarray(site_mask), jnp.asarray(masks_a),
               jnp.asarray(masks_b), length)
    for k, kind in enumerate(("pi", "pi", "pi", "fst", "int")):
        close(got[k], want[k], kind)
    # and against the replicated [N, N] path of the port
    t = [torch.from_numpy(a) for a in (geno, member, site_mask)]
    sim, present = identity_from_alleles(*t, length)
    ref = hudson_fst_direct_pairs(sim, present, torch.from_numpy(masks_a),
                                  torch.from_numpy(masks_b))
    for k, f in enumerate(("pi_a", "pi_b", "dxy")):
        close(got[k], getattr(ref, f), "pi")
    close(got[3], ref.fst, "fst")
    assert int(got[4]) == int(segregating_sites(*t))


@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_pair_sharded_batch_matches_single_calls_and_jax(n_dev):
    """A device batch of windows of different N and S, padded to shared
    caps (non-member rows, masked-off sites), in one call: each window's
    S equals its single-window call exactly and its sums (π within A and
    B, Dxy) agree at rtol 1e-6; each window against the JAX function."""
    rng = np.random.default_rng(40 + n_dev)
    shapes = [(24, 40), (32, 64), (16, 17), (40, 96), (36, 50)]
    cap_n, cap_s, q = 40, 96, 3
    w = len(shapes)
    geno = np.full((w, cap_n, cap_s), -1, np.int8)
    member = np.zeros((w, cap_n), bool)
    site_mask = np.zeros((w, cap_s), bool)
    masks_a = np.zeros((w, q, cap_n), bool)
    masks_b = np.zeros((w, q, cap_n), bool)
    lengths = np.asarray([5000.0, 1000.0, 0.0, 2500.0, 10000.0], np.float32)
    windows = []
    for wi, (n, s) in enumerate(shapes):
        g = rng.integers(0, 2, size=(n, s)).astype(np.int8)
        g[rng.random((n, s)) < 0.1] = -1
        mem = np.ones(n, bool)
        mem[-3:] = False
        ma, mb = np.zeros((q, n), bool), np.zeros((q, n), bool)
        for qi in range(q):
            perm = rng.permutation(n)
            ma[qi, perm[:n // 3]] = True
            mb[qi, perm[n // 3:2 * n // 3]] = True
        ma &= mem
        mb &= mem
        geno[wi, :n, :s] = g
        member[wi, :n] = mem
        site_mask[wi, :s] = True
        masks_a[wi, :, :n] = ma
        masks_b[wi, :, :n] = mb
        windows.append((g, mem, np.ones(s, bool), ma, mb))

    fn = pair_sharded_direct_stats(tmesh.make_mesh(data=n_dev,
                                                   devices=cpus(n_dev)))
    got = fn(geno, member, site_mask, masks_a, masks_b, lengths)
    assert [tuple(x.shape) for x in got] == [(w, q)] * 4 + [(w,)]
    assert got[4].dtype == torch.int32
    jfn = jpair.pair_sharded_direct_stats(jmesh.make_mesh(data=n_dev),
                                          axis="data")
    for wi, arrays in enumerate(windows):
        one = fn(*arrays, float(lengths[wi]))
        assert int(got[4][wi]) == int(one[4])
        for k in range(3):
            np.testing.assert_allclose(got[k][wi].numpy(), one[k].numpy(),
                                       rtol=1e-6, atol=1e-12)
        close(got[3][wi], one[3], "fst")
        want = jfn(*(jnp.asarray(a) for a in arrays), float(lengths[wi]))
        for k, kind in enumerate(("pi", "pi", "pi", "fst", "int")):
            close(got[k][wi], want[k], kind)


def test_pair_sharded_needs_rows_divisible():
    fn = pair_sharded_direct_stats(
        tmesh.make_mesh(data=3, devices=cpus(3)))
    z = np.zeros((8, 4), np.int8)
    with pytest.raises(ValueError, match="do not split"):
        fn(z, np.ones(8, bool), np.ones(4, bool), np.zeros((1, 8), bool),
           np.zeros((1, 8), bool), 100.0)


@pytest.mark.parametrize("n", [1, 4, 7, 100])
def test_host_window_range_partition(n):
    for k in (1, 2, 3, 8):
        covered = []
        for p in range(k):
            lo, hi = host_window_range(n, p, k)
            assert (lo, hi) == j_range(n, p, k)
            covered.extend(range(lo, hi))
        assert covered == list(range(n)), (n, k)


def test_mesh_shapes_and_errors():
    mesh = tmesh.make_mesh(devices=cpus(8), site=2)
    assert mesh.shape == {"data": 4, "site": 2}
    assert len(mesh.devices) == 8
    assert mesh.axis_devices("site") == cpus(2)
    with pytest.raises(ValueError, match="needs 12 devices, have 8"):
        tmesh.make_mesh(data=6, site=2, devices=cpus(8))
    with pytest.raises(ValueError, match="unknown mesh axis"):
        mesh.axis_devices("pairs")


@pytest.mark.parametrize("data,site", [(3, 1), (2, 4)])
def test_split_gather_reduce_roundtrip(data, site):
    mesh = tmesh.make_mesh(data=data, site=site, devices=cpus(data * site))
    x = torch.arange(7 * 5 * 6).reshape(7, 5, 6)
    rows = tmesh.split_windows(x, mesh)
    assert [r.shape[0] for r in rows] == [-(-7 // data)] * data
    assert torch.equal(tmesh.gather_windows(rows, 7), x)
    padded = tmesh.gather_windows(rows)
    assert not padded[7:].any()           # zero padding rows
    grid = tmesh.split_sites(x, mesh, 2)
    sums = [tmesh.reduce_sum([p.sum(dim=2) for p in row]) for row in grid]
    assert torch.equal(tmesh.gather_windows(sums, 7), x.sum(dim=2))
    mins = [tmesh.reduce_min([p.amin(dim=2) for p in row]) for row in grid]
    maxs = [tmesh.reduce_max([p.amax(dim=2) for p in row]) for row in grid]
    if 6 % site == 0:                     # no padding column inside
        assert torch.equal(tmesh.gather_windows(mins, 7), x.amin(dim=2))
    assert torch.equal(tmesh.gather_windows(maxs, 7), x.amax(dim=2))


@pytest.mark.parametrize("idx", [(0,), (2, 3, 4), (3, 1, 1, 0), ()])
def test_take_matches_list_indexing(idx):
    x = torch.arange(2 * 5 * 3).reshape(2, 5, 3)
    assert torch.equal(take(x, idx, -2), x[:, list(idx), :])
    assert torch.equal(take(x, idx, 1), x[:, list(idx)])
    last = [i % 3 for i in idx]
    assert torch.equal(take(x, last, -1), x[..., last])


# ---------------------------------------------------------------- dry run


@pytest.mark.parametrize("n_devices", [2, 8])
def test_dryrun_multidevice_cpu(n_devices):
    report = dryrun_multidevice(n_devices, "cpu")
    assert set(report) == {"batch_hudson", "site_sharded_window_stats",
                           "pair_sharded_direct_stats", "scan_deal",
                           "scan_deal bitwise"}
    assert report["scan_deal bitwise"] is True
    with pytest.raises(ValueError, match="even"):
        dryrun_multidevice(3, "cpu")
