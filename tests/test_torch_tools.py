"""The port's measurement and verification scripts (impop_tpu_torch.bench,
the twins of tools/) run at tiny shapes on the CPU with the plain
versions: each ends with 0, the checks among them fail when a route or a
statistic is made wrong, and the extraction smoke runs without torch.
The degenerate batches of ``bench/degenerate.py`` carry the kind they
name, and its comparison fails on a changed output."""
from __future__ import annotations

import os
import subprocess
import sys

import pytest
import torch

from impop_tpu_torch.bench import check_device_oracle as cdo
from impop_tpu_torch.bench import main as bench_main
from impop_tpu_torch.bench import (degenerate, extract, extract_smoke,
                                   gpu_smoke, panelstep, pairwise,
                                   windowstat)
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
                                    panelstep, windowstat, degenerate])
def test_card_scripts_refuse_cuda_without_a_card(module):
    """Without CUDA, the default device raises: no script falls back to
    the CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        module.main([])


def test_kernel_shapes_needs_a_card():
    """The parent-against-change timing script exits 2 without CUDA and
    runs nothing on the CPU."""
    from impop_tpu_torch.bench import kernel_shapes

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    assert kernel_shapes.main() == 2


@pytest.mark.parametrize("kind", degenerate.KINDS)
def test_degenerate_batches_carry_their_kind(kind):
    """The kind's windows (first, middle, last) have no segregating site
    among members, the others have some; the panels hold an empty and a
    one-member panel."""
    import numpy as np

    geno, member, smask, _, n_hap = degenerate.degenerate_windows(
        7, 9, 64, 96, kind)
    rows = degenerate.degenerate_rows(9)
    assert rows == [0, 4, 8]
    for wi in range(9):
        g = geno[wi][member[wi]][:, smask[wi]]
        valid = g >= 0
        seg = valid.any(0) & (np.where(valid, g, -1).max(0, initial=-1)
                              > np.where(valid, g, 2).min(0, initial=2))
        assert (int(seg.sum()) == 0) == (wi in rows), (kind, wi)
    pm = degenerate.degenerate_panels(7, 9, 64, n_hap, overlapping=True)
    assert not pm[:, 0].any() and (pm[:, 1].sum(-1) == 1).all()
    assert (pm[:, 2:].sum(-1) > 1).all()


def test_degenerate_cases_run_and_compare_on_the_cpu(capsys):
    assert degenerate.main(CPU + ["-k=-37x"]) == 0
    out = capsys.readouterr().out
    assert "degenerate: 17 cases on cpu" in out, out
    got, want, exact = degenerate.run_case(
        "masked_pair_sums-empty_rows-37x128x3-01", torch.device("cpu"))
    assert degenerate.compare(got, want, exact, "same") == 0.0
    worse = [t.clone() for t in got]
    worse[1][0, 2, 5] += 1.0
    with pytest.raises(AssertionError, match="output 1 differs"):
        degenerate.compare(worse, want, exact, "changed")
    worse[1][0, 2, 5] = float("nan")
    with pytest.raises(AssertionError, match="NaN in other places"):
        degenerate.compare(worse, want, exact, "nan")
