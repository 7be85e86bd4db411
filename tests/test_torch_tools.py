"""The port's measurement and verification scripts (impop_tpu_torch.bench,
the twins of tools/) run at tiny shapes on the CPU with the plain
versions: each ends with 0, the checks among them fail when a route or a
statistic is made wrong, and the extraction smoke runs without torch."""
from __future__ import annotations

import os
import subprocess
import sys

import pytest
import torch

from impop_tpu_torch.bench import check_device_oracle as cdo
from impop_tpu_torch.bench import main as bench_main
from impop_tpu_torch.bench import (extract, extract_smoke, gpu_smoke,
                                   panelstep, pairwise, windowstat)
from impop_tpu_torch.stats import panelstats

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]


def test_check_device_oracle_passes_on_the_cpu(capsys):
    assert cdo.main(CPU + ["--windows", "2"]) == 0
    out = capsys.readouterr().out
    assert out.count("OK over 2 windows") == 2, out


def test_check_device_oracle_fails_on_a_wrong_statistic(monkeypatch,
                                                        capsys):
    rows = cdo.device_rows

    def off_by_a_bit(dev, batch, return_matrices):
        pi, fst, fstg, s = rows(dev, batch, return_matrices)
        fstg = fstg.copy()
        fstg[1, 3] += 3e-3
        return pi, fst, fstg, s

    monkeypatch.setattr(cdo, "device_rows", off_by_a_bit)
    assert cdo.main(CPU + ["--windows", "2"]) == 1
    assert "FstG" in capsys.readouterr().out


def test_gpu_smoke_runs_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    assert gpu_smoke.main(CPU + ["--windows", "3",
                                 "--overlap-windows", "3"]) == 0
    out = capsys.readouterr().out
    assert "gpu_smoke 1 OK" in out and "gpu_smoke 2 OK" in out


def test_pairwise_runs_on_the_cpu(capsys):
    assert pairwise.main(CPU + ["--n", "64", "--s", "256", "--windows", "2",
                                "--reps", "1"]) == 0
    out = capsys.readouterr().out
    for name in ("unit", "weighted", "bmm-bf16", "fp32-torch"):
        assert f"{name} " in out, out


def test_panelstep_runs_on_the_cpu(capsys):
    assert panelstep.main(CPU + ["--windows", "2", "--iters", "1"]) == 0
    assert capsys.readouterr().out.count("us/window") == 6


def test_windowstat_routes_agree_on_the_cpu(capsys):
    assert windowstat.main(CPU + ["--windows", "2", "--sweep-windows", "2",
                                  "--sites", "128", "256",
                                  "--iters", "1"]) == 0
    assert capsys.readouterr().out.count("rows agree") == 3


def test_windowstat_finds_a_route_that_disagrees(monkeypatch, capsys):
    composed = panelstats.composed_window_stats

    def wrong_s(*args, **kwargs):
        s, res = composed(*args, **kwargs)
        return s + 1.0, res

    monkeypatch.setattr(panelstats, "composed_window_stats", wrong_s)
    assert windowstat.main(CPU + ["--windows", "1", "--sweep-windows", "1",
                                  "--sites", "128", "--iters", "1"]) == 1
    assert "differs" in capsys.readouterr().out


def test_extract_runs(capsys):
    assert extract.main(["--ref-len", "20000", "--per-call", "2",
                         "--threads", "1", "2", "--passes", "1"]) == 0
    assert "threads=2" in capsys.readouterr().out


def test_extract_smoke_runs_without_torch():
    assert extract_smoke.main(["--threads", "2"]) == 0
    code = ("import runpy, sys\n"
            "sys.argv = ['extract_smoke', '--threads', '2']\n"
            "try:\n"
            "    runpy.run_module('impop_tpu_torch.bench.extract_smoke', "
            "run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    if e.code:\n"
            "        raise\n"
            "print('torch loaded:', 'torch' in sys.modules)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "torch loaded: False" in proc.stdout, proc.stdout


@pytest.mark.parametrize("module", [bench_main, cdo, gpu_smoke, pairwise,
                                    panelstep, windowstat])
def test_card_scripts_refuse_cuda_without_a_card(module):
    """Without CUDA, the default device raises: no script falls back to
    the CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        module.main([])
