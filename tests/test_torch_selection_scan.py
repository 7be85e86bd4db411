"""The HPRC v2 selection scan from PAF (``benchmark/configs/
hprc-v2-5kb-full-paf.json``: ``scan --paf --fasta --identity-mode columns
--ehh --afs``) through ``impop_tpu_torch.cli.main`` on the CPU, held to the
plain PyTorch reference (``benchmark/reference_torch.py``) on small seeded
pangenomes of ``benchmark/datagen.py``: exact cells equal, float cells
inside the configuration's limits, the spectrum file equal.  The PyTorch
reference is held to the NumPy one (``benchmark/reference.py``) cell by
cell, and imports neither package nor JAX; the seed peel's roofline count
scales with the windows scanned."""
from __future__ import annotations

import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import datagen, judge, reference_gaps
from benchmark.spec import load_module, load_spec

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "hprc5kb-full.paf-chrom"
SEEDS = [7, 2 ** 31 + 11]


@pytest.fixture(scope="module")
def cell():
    return load_spec(REPO).cell(CELL)


def _small(cfg: dict, panels: dict) -> dict:
    """The configuration at a CPU's size: four 5 kb windows (about 80
    sites each, half of them indels), a few dozen haplotypes, batches of
    three windows."""
    cfg = copy.deepcopy(cfg)
    cfg["data"]["region_bp"] = 20000
    cfg["data"]["panels"] = panels
    cfg["scan"]["batch"] = 3
    return cfg


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("panels", [{"AFR": 12, "EUR": 8},
                                    {"AFR": 10, "AMR": 6, "EAS": 8}])
def test_scan_matches_torch_reference(cell, tmp_path, seed, panels):
    cfg = _small(cell.config, panels)
    pg = datagen.make_pangenome(cfg, seed)
    truth = judge.WindowTruth(pg, cfg)
    windows = reference_gaps.sample_windows(truth, cfg, cell.traffic, seed)
    assert len(windows) == 4
    assert min(truth.facts(w)["geno"].shape[1] for w in windows) > 1
    assert any((truth.weights(truth.facts(w)["keys"]) > 1).any()
               for w in windows)                    # indels
    command = load_spec(REPO).command(cell.traffic["command"])
    got = reference_gaps.port_vs_torch(command, cfg, cell.traffic, pg,
                                       windows, str(tmp_path), "cpu")
    limits = cfg["limits"]
    assert set(got) == set(limits)
    assert got["rows_wrong"] == 0          # exact cells and the spectrum
    for key, v in got.items():
        assert v <= limits[key], (key, v)


def test_journal_spectra_per_window(cell, tmp_path):
    """Each window's journal record holds its own sparse spectrum, the
    reference's nonzero bins of count >= 1 in panel-then-count order."""
    from benchmark import harness, loops
    from impop_tpu_torch import cli

    cfg = _small(cell.config, {"AFR": 12, "AMR": 6, "EUR": 8})
    pg = datagen.make_pangenome(cfg, SEEDS[0])
    windows = loops.tiled(cfg)
    inputs = harness._inputs(cfg, cell.traffic, pg, str(tmp_path / "data"))
    paths = loops.call_paths(str(tmp_path), 0)
    loops.write_bed(paths["bed"], cfg["chrom"], windows)
    journal = tmp_path / "journal.jsonl"
    command = load_spec(REPO).command(cell.traffic["command"])
    assert cli.main(command.argv(cfg, cell.traffic, inputs, paths, "cpu")
                    + ["--journal", str(journal)]) == 0
    truth = reference_gaps.TorchTruth(pg, cfg)
    recs = [json.loads(ln) for ln in journal.read_text().splitlines()]
    assert [r["region"] for r in recs] == [truth.region(w) for w in windows]
    for w, rec in zip(windows, recs):
        hist = truth.afs(w)
        want = {f"{p}:{k}": int(hist[p, k]) for p in range(hist.shape[0])
                for k in range(1, hist.shape[1]) if hist[p, k]}
        assert list(rec["afs"].items()) == list(want.items())


@pytest.mark.parametrize("seed", SEEDS)
def test_torch_reference_matches_numpy_reference(cell, seed):
    cfg = _small(cell.config, {"AFR": 14, "AMR": 8, "EUR": 6})
    pg = datagen.make_pangenome(cfg, seed)
    windows = [(lo, lo + 5000) for lo in range(0, 20000, 5000)]
    gaps = reference_gaps.torch_vs_numpy(pg, cfg, windows, "cpu")
    assert gaps["exact_cells_differ"] == 0
    assert gaps["stat_gap"] <= 1e-12 and gaps["tajd_gap"] <= 1e-9
    assert gaps["ehh_gap"] <= 1e-12


def test_torch_reference_imports_torch_and_numpy_only():
    code = ("import sys; import benchmark.reference_torch; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    loaded = set(json.loads(out.stdout.replace("'", '"')))
    assert not loaded & {"jax", "jaxlib", "impop_tpu", "impop_tpu_torch"}
    with open(os.path.join(REPO, "benchmark", "reference_torch.py")) as fh:
        tops = {ln.split()[1].split(".")[0] for ln in fh
                if ln.startswith(("import ", "from "))}
    assert tops == {"__future__", "math", "typing", "numpy", "torch"}


class _Run:
    """A run whose calls scanned ``windows``: two panels, one pair."""

    def __init__(self, windows):
        self._windows = windows

        class Truth:
            pairs = [(0, 1)]

            def facts(self, w):
                n = 6 if w[0] else 4
                return {"geno": np.zeros((n, 3), np.int8),
                        "masks": np.ones((2, n), bool)}

        self.truth = Truth()

    def windows(self):
        yield from self._windows


def test_seed_peel_count_scales_with_the_batch():
    mod = load_module(os.path.join(REPO, "benchmark", "rooflines",
                                   "seed_peel.py"), "t_seed_peel")
    assert mod.KERNELS == ("seed_link_kernel", "seed_peel_kernel")
    one = [(0, 10), (10, 20)]
    ops1, bytes1 = mod.work(_Run(one))
    ops4, bytes4 = mod.work(_Run(one * 4))
    assert ops1["fp32"] > 0 and bytes1 > 0
    assert ops4["fp32"] == 4 * ops1["fp32"] and bytes4 == 4 * bytes1
    # N = 4 and 6, three masks: the upper triangles (6 + 15 pairs, five
    # bytes each), member and masks in, seeds and gids out
    assert ops1["fp32"] == 6 + 15
    assert bytes1 == 5 * 21 + (4 + 6) * (1 + 3 + 5 * 3)
