"""Whole runs on the CPU at a tiny size: the last line meets the
contract, a cell is found from files alone, and no run loads JAX."""
import json
import os
import sys
import types

import pytest

from benchmark import run as bench_run
from benchmark.tests.tiny import run_tiny, tiny_root

CELLS = ["hprc5kb.paf-chrom", "hprc5kb-full.tiles-chrom", "hprc5kb.locus"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(str(tmp_path_factory.mktemp("tiny")))


def _check_line(res, spec_doc, cell, traced):
    assert list(res)[-1] == "checks"
    assert isinstance(res["correct"], bool) and res["correct"]
    assert isinstance(res["attempted"], int) and res["attempted"] > 0
    assert res["failed"] == 0
    dev = res["device"]
    for key in ("platform", "kind", "count", "memory_peak_bytes"):
        assert key in dev
    group = "per_layer" if traced else "end_to_end"
    due = {m["name"]: m["unit"] for m in spec_doc[group]
           if cell in m.get("workloads", [cell])}
    for name, m in res["metrics"].items():
        assert m["unit"] == due[name] and isinstance(m["value"], float)
    if traced:
        assert {"busy_s", "window_s"} <= set(dev)
        for key in ("device_ops", "idle_gaps"):
            assert len(res["breakdown"][key]) <= 10
    else:
        assert set(res["metrics"]) == set(due)
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]
    json.dumps(res)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_last_line(root, cell, traced):
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        doc = json.load(fh)
    res = run_tiny(root, cell, seed=2 ** 32 + 7, traced=traced)
    _check_line(res, doc, cell, traced)
    assert not os.path.exists(os.path.join(root, "benchmark", "_work"))


@pytest.mark.parametrize("command", ["scan", "tajd"])
def test_dummy_cell_from_new_files(root, tmp_path, command):
    """A cell, configuration, mix and per-layer metric added by new files
    and new entries alone, for the scan and for another command of the
    port's CLI (``tajd --geno-dir``, ``benchmark/commands/tajd.py``)."""
    import shutil

    new = str(tmp_path / "root")
    shutil.copytree(root, new)
    bench = os.path.join(new, "benchmark")
    with open(os.path.join(bench, "configs", "hprc-v2-5kb.json")) as fh:
        cfg = json.load(fh)
    cfg["data"]["region_bp"] = 30000
    with open(os.path.join(bench, "configs", "dummy.json"), "w") as fh:
        json.dump(cfg, fh)
    with open(os.path.join(bench, "traffic", "dummy-mix.json"), "w") as fh:
        json.dump({"command": command, "input": "tiles", "loop": "passes",
                   "repeat": 2, "warmup_windows": 4}, fh)
    with open(os.path.join(bench, "metrics", "dummy_calls.py"), "w") as fh:
        fh.write("def read(run):\n    return float(len(run.calls))\n")
    with open(os.path.join(new, "BENCHMARK.json")) as fh:
        doc = json.load(fh)
    doc["configs"].append({"name": "dummy", "source": "test",
                           "file": "benchmark/configs/dummy.json",
                           "reduced": [], "why": "test"})
    doc["workloads"].append({"name": "dummy.cell", "config": "dummy",
                             "traffic": "dummy-mix", "chips": 1,
                             "why": "test"})
    for m in doc["end_to_end"]:
        if m["name"] == "windows_per_s":
            m["workloads"].append("dummy.cell")
    doc["per_layer"].append({"name": "dummy_calls", "unit": "calls",
                             "better": "higher", "source": "host_clock",
                             "layer": "scan loop", "moves": "windows_per_s",
                             "workloads": ["dummy.cell"]})
    with open(os.path.join(new, "BENCHMARK.json"), "w") as fh:
        json.dump(doc, fh)
    plain = run_tiny(new, "dummy.cell")
    assert plain["correct"], plain["checks"]
    assert set(plain["metrics"]) == {"windows_per_s", "setup_s"}
    traced = run_tiny(new, "dummy.cell", traced=True)
    assert traced["correct"], traced["checks"]
    assert traced["metrics"]["dummy_calls"]["value"] >= 1
    assert traced["attempted"] == 12 * traced["metrics"]["dummy_calls"][
        "value"]


def test_metric_names_resolve(root):
    """Every metric of the benchmark and of the later cells finds a
    reader: its own file, the file of its name without the suffix, or a
    kernel's count."""
    from benchmark.spec import load_spec

    spec = load_spec(root)
    for group in ("end_to_end", "per_layer"):
        for m in spec.doc[group]:
            assert callable(spec.metric_reader(m["name"]).read), m["name"]
    with pytest.raises(FileNotFoundError):
        spec.metric_reader("no_such_kernel_roofline")


def test_no_result_without_a_gpu(capsys, monkeypatch, root):
    import torch

    monkeypatch.chdir(root)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = bench_run.main(["--workload", CELLS[0], "--seed", "1",
                         "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_forbidden_modules(monkeypatch):
    import impop_tpu_torch  # noqa: F401  the port itself passes

    assert bench_run.forbidden_modules() == []
    for name in ("jax", "jaxlib.xla_client", "flax", "impop_tpu.cli"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert bench_run.forbidden_modules() == sorted(
        ["jax", "jaxlib.xla_client", "flax", "impop_tpu.cli"])
