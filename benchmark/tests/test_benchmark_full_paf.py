"""The cell ``hprc5kb-full.paf-chrom`` at a tiny size on the CPU: its last
line, traced and not, with the new per-layer metrics read; the control
fails a limit where the reference passes; a broken timed path is not
``correct``.  The seed peel's count is tested in tier 1
(``tests/test_torch_selection_scan.py``)."""
import json
import os

import pytest

from benchmark import control, loops
from benchmark.spec import load_spec
from benchmark.tests.test_benchmark_checks import _broken_step
from benchmark.tests.test_benchmark_runs import _check_line
from benchmark.tests.tiny import run_tiny, tiny_root

CELL = "hprc5kb-full.paf-chrom"
NEW = ["step_identity_ms_per_batch.full", "step_groups_ms_per_batch.full",
       "step_ehh_ms_per_batch.full", "step_afs_ms_per_batch.full",
       "emit_afs_ms_per_batch.full"]
# the accepted program-read metrics this cell reports too (the device's
# step time needs a CUDA trace)
SHARED = ["step_cpu_ms_per_batch.scan", "step_epilogue_ms_per_batch.scan",
          "build_cpu_ms_per_window.scan", "extract_native_ms_per_window.scan",
          "open_native_ms_per_call.scan", "extractors_open.scan"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(str(tmp_path_factory.mktemp("tiny_full_paf")))


@pytest.mark.parametrize("traced", [False, True])
def test_last_line(root, traced):
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        doc = json.load(fh)
    res = run_tiny(root, CELL, seed=2 ** 32 + 9, traced=traced)
    _check_line(res, doc, CELL, traced)
    assert set(res["checks"]) == {"rows_wrong", "stat_gap", "tajd_gap",
                                  "ehh_gap"}
    if traced:
        for name in NEW:
            assert res["metrics"][name]["value"] > 0, name
        c = load_spec(root).cell(CELL)
        calls = res["attempted"] // len(loops.pass_windows(c.config,
                                                           c.traffic))
        for name in SHARED:
            if name == "extractors_open.scan" and calls < 2:
                continue                # a rise needs two calls
            assert res["metrics"][name]["value"] >= 0, name


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 5])
def test_control_fails_and_reference_passes(root, seed):
    c = load_spec(root).cell(CELL)
    command = load_spec(root).command(c.traffic["command"])
    limits = c.config["limits"]
    ctl = control.control_numbers(command, c.config, c.traffic, seed)
    assert any(v > limits[k] for k, v in ctl.items()), ctl
    ref = control.control_numbers(command, c.config, c.traffic, seed,
                                  mantissa=None)
    assert all(v <= limits[k] for k, v in ref.items()), ref


@pytest.mark.parametrize("fault", ["half", "altered"])
def test_broken_timed_path_is_not_correct(root, monkeypatch, fault):
    _broken_step(monkeypatch, fault)
    assert not run_tiny(root, CELL)["correct"]



def test_timed_run_against_the_torch_reference(root):
    """The PyTorch reference judges the calls of a timed run on the
    sample the run judged, and agrees with the run's own checks."""
    from benchmark import reference_gaps

    result, port, sample = reference_gaps.timed_vs_torch(
        load_spec(root), CELL, 2 ** 31 + 21, 1.0, "cpu")
    assert result["correct"] and len(sample) == 4
    limits = load_spec(root).cell(CELL).config["limits"]
    assert set(port) == set(limits) and port["rows_wrong"] == 0
    for key, v in port.items():
        assert v <= limits[key], (key, v)
