"""The port's ``stats/ehh`` and its ``ehh`` command against the JAX
package on the CPU, and against the ehhgfa oracle where the JAX command
pads.

- Library: ``ehh_pair_death`` exact, ``ehh_forward`` /
  ``ehh_bidirectional`` / ``ehh_decay_from_focal`` curves atol 1e-6,
  ``ehh_area_batch`` (both modes, every site active) areas rtol 1e-6 and
  carriers exact against ``impop_tpu.stats.ehh``; with masked columns,
  against the JAX function on the windows with those columns dropped.
- ``ehh`` matrix mode on unpadded windows and extraction mode with one
  focal: output text identical to ``impop_tpu.cli``.  On a ragged last
  window and with several focals, where the JAX command counts padded
  columns as EHH steps, the rows equal the oracle of
  ``tests/test_ehh.py`` (the reference script's loop) at atol 1e-5, and a
  focal's area does not depend on the other focals of the run.
- Device batches forced small give the text of one batch.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import impop_tpu_torch.cli as torch_cli
from impop_tpu.cli import main as jax_main
from impop_tpu.stats import ehh as jehh
from impop_tpu_torch.cli import main as torch_main
from impop_tpu_torch.hostio import simulate
from impop_tpu_torch.stats import ehh as tehh
from test_ehh import _reference_ehh_cli_oracle, oracle_ehh

torch.set_num_threads(1)


def tile(seed, w, n, s, p_active=1.0):
    """Binarised windows of a few haplotype classes (pairs share runs),
    the last two rows not members."""
    rng = np.random.default_rng(seed)
    geno = np.zeros((w, n, s), np.int8)
    for wi in range(w):
        base = rng.integers(0, 2, size=(3, s)).astype(np.int8)
        g = base[rng.integers(0, 3, size=n)]
        geno[wi] = np.where(rng.random((n, s)) < 0.05, 1 - g, g)
    member = np.ones((w, n), bool)
    member[:, -2:] = False
    smask = rng.random((w, s)) < p_active
    return geno, member, smask


def tt(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("seed,n,s,p_active", [(1, 12, 30, 1.0),
                                               (2, 40, 70, 0.7),
                                               (3, 5, 1, 1.0)])
def test_pair_death_matches_jax(seed, n, s, p_active):
    geno, _, smask = tile(seed, 1, n, s, p_active)
    want = np.asarray(jehh.ehh_pair_death(jnp.asarray(geno[0]),
                                          jnp.asarray(smask[0])))
    got = tehh.ehh_pair_death(*tt(geno[0], smask[0]))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed,n,s,p_active", [(4, 12, 30, 1.0),
                                               (5, 33, 64, 0.8)])
def test_curves_match_jax(seed, n, s, p_active):
    geno, member, smask = tile(seed, 1, n, s, p_active)
    # codes past 0/1 and a missing call: the curves compare codes
    geno[0, 0, ::3] = 2
    geno[0, 1, 1] = -1
    args_j = [jnp.asarray(a[0]) for a in (geno, member, smask)]
    args_t = tt(geno[0], member[0], smask[0])
    for fj, ft in ((jehh.ehh_forward, tehh.ehh_forward),
                   (jehh.ehh_bidirectional, tehh.ehh_bidirectional)):
        want = np.asarray(fj(*args_j))
        got = ft(*args_t).numpy()
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("focal", [0, 7, 29])
@pytest.mark.parametrize("allele", [0, 1])
def test_decay_from_focal_matches_jax(focal, allele):
    geno, member, smask = tile(6, 1, 14, 30, 0.9)
    want = jehh.ehh_decay_from_focal(
        *(jnp.asarray(a[0]) for a in (geno, member, smask)), focal,
        jnp.int8(allele))
    got = tehh.ehh_decay_from_focal(*tt(geno[0], member[0], smask[0]),
                                    focal, allele)
    np.testing.assert_allclose(got.ehh.numpy(), np.asarray(want.ehh),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(got.area), float(want.area),
                               rtol=1e-6, atol=1e-6)
    assert int(got.carriers) == int(want.carriers)


def jax_batch(geno, member, smask, focal, compat):
    a, c = jehh.ehh_area_batch(jnp.asarray(geno), jnp.asarray(member),
                               jnp.asarray(smask), focal,
                               jnp.asarray([0, 1], jnp.int32),
                               compat_right_for_left=compat)
    return np.asarray(a), np.asarray(c)


@pytest.mark.parametrize("focal", [0, 1, 17, 39])
@pytest.mark.parametrize("compat", [False, True])
def test_area_batch_matches_jax(focal, compat):
    geno, member, smask = tile(7, 6, 24, 40)
    a_j, c_j = jax_batch(geno, member, smask, focal, compat)
    a_t, c_t = tehh.ehh_area_batch(*tt(geno, member, smask), focal,
                                   compat_right_for_left=compat)
    assert a_t.dtype == torch.float32 and c_t.dtype == torch.int32
    np.testing.assert_array_equal(c_t.numpy(), c_j)
    np.testing.assert_allclose(a_t.numpy(), a_j, rtol=1e-6, atol=0)


@pytest.mark.parametrize("compat", [False, True])
def test_area_batch_per_window_focal(compat):
    """A focal per window gives each window's area at its own focal."""
    geno, member, smask = tile(8, 5, 16, 25)
    focal = np.asarray([0, 24, 3, 12, 23])
    a_t, c_t = tehh.ehh_area_batch(*tt(geno, member, smask),
                                   torch.from_numpy(focal),
                                   compat_right_for_left=compat)
    for wi, f in enumerate(focal):
        a_j, c_j = jax_batch(geno[wi:wi + 1], member[wi:wi + 1],
                             smask[wi:wi + 1], int(f), compat)
        np.testing.assert_array_equal(c_t.numpy()[wi], c_j[0])
        np.testing.assert_allclose(a_t.numpy()[wi], a_j[0], rtol=1e-6,
                                   atol=0)


@pytest.mark.parametrize("compat", [False, True])
def test_area_batch_counts_active_sites_only(compat):
    """Masked columns anywhere in the tile: the area of the window with
    those columns dropped (the JAX function counts them as steps)."""
    geno, member, smask = tile(9, 6, 20, 36, 0.7)
    focal = np.zeros(6, np.int64)
    for wi in range(6):
        act = np.nonzero(smask[wi])[0]
        focal[wi] = act[(0, len(act) // 2, len(act) - 1)[wi % 3]]
    geno[~np.broadcast_to(smask[:, None, :], geno.shape)] = -1
    a_t, c_t = tehh.ehh_area_batch(*tt(geno, member, smask),
                                   torch.from_numpy(focal),
                                   compat_right_for_left=compat)
    for wi in range(6):
        act = np.nonzero(smask[wi])[0]
        g = geno[wi][:, act][None]
        f = int(np.searchsorted(act, focal[wi]))
        a_j, c_j = jax_batch(g, member[wi:wi + 1],
                             np.ones((1, len(act)), bool), f, compat)
        np.testing.assert_array_equal(c_t.numpy()[wi], c_j[0])
        np.testing.assert_allclose(a_t.numpy()[wi], a_j[0], rtol=1e-6,
                                   atol=0)


def test_area_batch_single_carrier_and_other_alleles():
    geno, member, smask = tile(10, 2, 8, 12)
    geno[:, :, 4] = 0
    geno[:, 3, 4] = 1          # one carrier of allele 1: area 0
    a, c = tehh.ehh_area_batch(*tt(geno, member, smask), 4)
    assert c[:, 1].tolist() == [1, 1] and a[:, 1].tolist() == [0.0, 0.0]
    a_j, c_j = jax_batch(geno, member, smask, 4, False)
    np.testing.assert_allclose(a.numpy(), a_j, rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="alleles"):
        tehh.ehh_area_batch(*tt(geno, member, smask), 4, alleles=(1, 2))
    with pytest.raises(ValueError, match="focal"):
        tehh.ehh_area_batch(*tt(geno, member, smask), 12)


# ------------------------------------------------------------ the command


def run_both(tmp_path, argv, tag):
    j, t = tmp_path / f"{tag}.jax", tmp_path / f"{tag}.torch"
    assert jax_main(argv + ["-o", str(j)]) == 0
    assert torch_main(argv + ["-o", str(t), "--device", "cpu"]) == 0
    return j.read_text(), t.read_text()


def matrix(tmp_path, seed, n, sites):
    whole = np.random.default_rng(seed).integers(0, 2, size=(n, sites))
    path = tmp_path / f"m{seed}.txt"
    np.savetxt(path, whole, fmt="%d")
    return whole, str(path)


@pytest.mark.parametrize("compat", [False, True])
def test_matrix_mode_text_equals_jax(tmp_path, compat):
    _, path = matrix(tmp_path, 0, 12, 1000)
    argv = ["ehh", "-i", path, "-p", "4", "-w", "10"]
    if compat:
        argv.append("--compat-ehhgfa")
    want, got = run_both(tmp_path, argv, "m")
    assert len(want.splitlines()) > 150
    assert got == want


def parse_matrix_rows(text):
    rows = []
    for line in text.splitlines():
        w, cs, ce, al, t, area = line.split()
        rows.append((int(w), int(cs), int(ce), int(al), t, float(area)))
    return rows


@pytest.mark.parametrize("compat", [False, True])
def test_matrix_mode_ragged_tail_matches_oracle(tmp_path, compat):
    """12 x 1005, -p 4 -w 10: window 101 holds 5 sites.  The JAX command
    pads it to 10 and counts the padding as steps; the port gives the
    oracle's area (REF 1.417 in the default mode, where JAX reads
    3.639)."""
    whole, path = matrix(tmp_path, 3, 12, 1005)
    argv = ["ehh", "-i", path, "-p", "4", "-w", "10"]
    if compat:
        argv.append("--compat-ehhgfa")
    want_jax, got = run_both(tmp_path, argv, "r")
    oracle = _reference_ehh_cli_oracle(whole, 3, 10, 1, compat)
    rows = parse_matrix_rows(got)
    assert [r[:5] for r in rows] == [o[:5] for o in oracle]
    np.testing.assert_allclose([r[5] for r in rows], [o[5] for o in oracle],
                               rtol=0, atol=1e-5)
    tail = [r for r in rows if r[0] == 101]
    jax_tail = [r for r in parse_matrix_rows(want_jax) if r[0] == 101]
    assert len(tail) == 2 and tail != jax_tail
    if not compat:
        assert tail[0][4] == "REF" and round(tail[0][5], 3) == 1.417
        assert round(jax_tail[0][5], 3) == 3.639
    # the full windows print the JAX text
    assert [ln for ln in got.splitlines() if not ln.startswith("101 ")] == \
        [ln for ln in want_jax.splitlines() if not ln.startswith("101 ")]


@pytest.mark.parametrize("compat", [False, True])
def test_matrix_mode_batches_and_edges(tmp_path, monkeypatch, compat):
    """Device batches of 3 windows give the text of one batch; the focal
    on the last site of a window (compat tile [focal] alone, S = 1)
    matches JAX."""
    _, path = matrix(tmp_path, 5, 9, 60)
    for pos in ("1", "10"):
        argv = ["ehh", "-i", path, "-p", pos, "-w", "10"]
        if compat:
            argv.append("--compat-ehhgfa")
        want, one = run_both(tmp_path, argv, f"b{pos}")
        assert one == want
        monkeypatch.setattr(torch_cli, "_WINDOW_CHUNK_ELEMS", 3 * 9 * 10)
        small = tmp_path / f"b{pos}.small"
        assert torch_main(argv + ["-o", str(small), "--device", "cpu"]) == 0
        monkeypatch.undo()
        assert small.read_text() == one


@pytest.fixture(scope="module")
def pangenome(tmp_path_factory):
    """Two 2 kb windows of a simulated 12-haplotype pangenome, as PAF +
    FASTA and as allele tiles."""
    from impop_tpu_torch.extract import NativeExtractor

    tmp = tmp_path_factory.mktemp("ehh_pg")
    sim = simulate(str(tmp), ref_len=4000, n_haps=12, seed=17,
                   site_pool=30, span=(0, 4000))
    bed = tmp / "w.bed"
    bed.write_text("chr1\t0\t2000\nchr1\t2000\t4000\n")
    tiles = tmp / "tiles"
    tiles.mkdir()
    ex = NativeExtractor(sim.paf_path, sim.fasta_path)
    wms = []
    for lo, hi in ((0, 2000), (2000, 4000)):
        wm = ex.extract(sim.ref_name, lo, hi)
        np.savez(tiles / f"CHM13#0#chr1:{lo}-{hi}.npz", geno=wm.geno,
                 names=np.asarray(wm.names),
                 site_keys=np.asarray(wm.site_keys))
        wms.append(wm)
    return sim, str(bed), str(tiles), wms


def focal_site(wm, skip=0):
    """A variant where both alleles have two carriers or more."""
    h = (np.asarray(wm.geno) == 1).astype(np.int8)
    counts = h.sum(0)
    ok = np.nonzero((counts >= 2) & (counts <= h.shape[0] - 2))[0]
    return int(ok[skip]), h


@pytest.mark.parametrize("source", ["paf", "geno"])
@pytest.mark.parametrize("compat", [False, True])
def test_extraction_one_focal_text_equals_jax(tmp_path, pangenome, source,
                                              compat):
    sim, bed, tiles, wms = pangenome
    fi, _ = focal_site(wms[0])
    src = (["--paf", sim.paf_path, "--fasta", sim.fasta_path]
           if source == "paf" else ["--geno-dir", tiles])
    argv = ["ehh", *src, "-b", bed, "-P", "CHM13#0#", "--focal",
            str(int(wms[0].site_pos[fi]))]
    if compat:
        argv.append("--compat-ehhgfa")
    want, got = run_both(tmp_path, argv, "x")
    assert len(got.splitlines()) == 2
    assert got == want


def oracle_area(h, fi, allele):
    """The reference loop on one tile: left and right decay of the
    carriers of ``allele`` at column ``fi``."""
    sub = h[h[:, fi] == allele]
    total = 0.0
    for half in (sub[:, :fi][:, ::-1], sub[:, fi + 1:]):
        if half.shape[1] and half.shape[0] >= 2:
            total += float(np.sum(oracle_ehh(half)))
    return total


def test_extraction_focals_do_not_interact(tmp_path, pangenome):
    """Two focals in different windows: each row is the per-tile oracle's
    area and equals the row of the focal run alone."""
    sim, bed, tiles, wms = pangenome
    fi0, h0 = focal_site(wms[0], skip=1)
    fi1, h1 = focal_site(wms[1], skip=-1)
    pos = [int(wms[0].site_pos[fi0]), int(wms[1].site_pos[fi1])]
    base = ["ehh", "--geno-dir", tiles, "-b", bed, "-P", "CHM13#0#",
            "--device", "cpu"]
    both = tmp_path / "both.tsv"
    torch_main(base + ["--focal", str(pos[0]), "--focal", str(pos[1]),
                       "-o", str(both)])
    rows = [ln.split() for ln in both.read_text().splitlines()]
    assert len(rows) == 4
    alone = []
    for p in pos:
        out = tmp_path / f"alone{p}.tsv"
        torch_main(base + ["--focal", str(p), "-o", str(out)])
        alone += out.read_text().splitlines()
    assert both.read_text().splitlines() == alone
    for parts, (h, fi) in zip(rows, [(h0, fi0)] * 2 + [(h1, fi1)] * 2):
        allele = int(parts[4])
        assert int(parts[6]) == int((h[:, fi] == allele).sum())
        np.testing.assert_allclose(float(parts[7]),
                                   oracle_area(h, fi, allele), rtol=0,
                                   atol=1e-5)
