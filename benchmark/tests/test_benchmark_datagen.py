"""The generator: the same seed gives the same inputs, and its record of
each window's columns is what the port's extractor reads back."""
import json
import os

import numpy as np
import pytest

from benchmark import datagen
from benchmark.tests.tiny import tiny_root

BIG_SEED = 2 ** 33 + 12345


@pytest.fixture(scope="module")
def cfg(tmp_path_factory):
    root = tiny_root(str(tmp_path_factory.mktemp("tiny")))
    with open(os.path.join(root, "benchmark", "configs",
                           "hprc-v2-5kb.json")) as fh:
        return json.load(fh)


def _digest(path):
    with open(path, "rb") as fh:
        return fh.read()


def test_same_seed_same_inputs(cfg, tmp_path):
    a = datagen.write_paf_fasta(datagen.make_pangenome(cfg, BIG_SEED),
                                str(tmp_path / "a"))
    b = datagen.write_paf_fasta(datagen.make_pangenome(cfg, BIG_SEED),
                                str(tmp_path / "b"))
    c = datagen.write_paf_fasta(datagen.make_pangenome(cfg, BIG_SEED + 1),
                                str(tmp_path / "c"))
    for x, y, z in zip(a, b, c):
        assert _digest(x) == _digest(y)
        assert _digest(x) != _digest(z)


def test_sizes_do_not_depend_on_the_seed(cfg):
    for seed in (1, BIG_SEED):
        pg = datagen.make_pangenome(cfg, seed)
        assert pg.carriers.shape == (
            sum(cfg["data"]["panels"].values())
            + 2 * cfg["data"]["other_samples"] + len(cfg["data"]["haploid"]),
            cfg["data"]["region_bp"] // cfg["data"]["site_every_bp"])
        assert [len(v) for v in pg.panels.values()] == list(
            cfg["data"]["panels"].values())


@pytest.mark.parametrize("window", [(0, 5000), (25000, 30000), (1234, 9876),
                                   (40001, 40003), (55000, 60000)])
def test_record_matches_the_extractor(cfg, tmp_path, window):
    from impop_tpu_torch.extract.pyfallback import PyExtractor

    pg = datagen.make_pangenome(cfg, BIG_SEED)
    paf, fasta = datagen.write_paf_fasta(pg, str(tmp_path))
    wm = PyExtractor(paf, fasta).extract(cfg["ref_name"], *window)
    idx, col, keys = datagen.window_sites(pg, *window)
    names, rows = datagen.row_names(pg, *window)
    assert list(wm.site_keys) == keys
    assert np.array_equal(np.asarray(wm.site_pos), col)
    assert [n.split(":")[0] for n in wm.names] == [
        n.split(":")[0] for n in names]
    assert np.array_equal(wm.geno, datagen.window_geno(pg, rows, idx))


def test_tiles_hold_the_record(cfg, tmp_path):
    pg = datagen.make_pangenome(cfg, 7)
    datagen.write_tiles(pg, [(5000, 10000)], str(tmp_path))
    d = np.load(tmp_path / f"{cfg['ref_name']}:5000-10000.npz",
                allow_pickle=False)
    idx, col, keys = datagen.window_sites(pg, 5000, 10000)
    names, rows = datagen.row_names(pg, 5000, 10000)
    assert list(d["site_keys"]) == keys
    assert list(d["names"]) == names
    assert np.array_equal(d["geno"], datagen.window_geno(pg, rows, idx))


def test_haplotypes_share_structure():
    """The genealogy gives haplotypes shared structure at the configured
    panels (60 kb of them): diversity near the human 1e-3 per bp, panels
    apart (Hudson Fst above 0), and groups at the threshold that join many
    members."""
    from benchmark import reference

    with open(os.path.join(os.path.dirname(datagen.__file__), "configs",
                           "hprc-v2-5kb.json")) as fh:
        cfg = json.load(fh)
    cfg["data"]["region_bp"] = 60000
    pg = datagen.make_pangenome(cfg, BIG_SEED)
    pis, fsts, groups, members = [], [], 0, 0
    for lo in range(0, 60000, 5000):
        idx, _, _ = datagen.window_sites(pg, lo, lo + 5000)
        _, rows = datagen.row_names(pg, lo, lo + 5000)
        g = datagen.window_geno(pg, rows, idx).astype(float)
        d = g @ (1 - g).T + (1 - g) @ g.T
        pis.append(d[np.triu_indices(len(g), 1)].mean() / 5000)
        masks = datagen.panel_masks(pg, rows)
        st = reference.window_stats(g.astype(np.int8), masks, 5000,
                                    [(0, 1)], 0.999)
        fsts.append(st["fst"][0])
        link = (np.float32(1) - d.astype(np.float32) / np.float32(5000)
                > np.float32(0.999))
        for m in masks:
            seeds, _ = reference._greedy(link, np.nonzero(m)[0])
            groups += seeds.size
            members += int(m.sum())
    assert 5e-4 < np.mean(pis) < 2e-3
    assert np.mean(fsts) > 0.0
    assert groups < 0.6 * members
