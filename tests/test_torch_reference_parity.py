"""The port's commands against the reference's own executables (the twin
of ``tests/test_reference_parity.py``): ``pi``, ``hud`` and ``afs`` with
``--device cpu`` on the original's randomized similarity fixtures, and
Tajima's D, each inside the reference's outcome set.  Under the same guard
as the original: the tests run wherever the reference checkout is mounted
and skip elsewhere."""
from __future__ import annotations

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from test_reference_parity import REF, _ref, _ref_outcomes, _write_fixture

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(
    not os.path.isdir(REF), reason="reference checkout not mounted")


def ours(argv):
    from impop_tpu_torch.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main([*argv, "--device", "cpu"])
    return buf.getvalue().strip()


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_pica2_stdout_parity(tmp_path, seed):
    tsv, _, _ = _write_fixture(tmp_path, np.random.default_rng(seed))
    want = _ref_outcomes("pica2.py", str(tsv), "-t", "0.999", "-r", "5",
                         "-l", "10000", "-d", str(tmp_path),
                         cwd=str(tmp_path))
    (tmp_path / "one.bed").write_text("chr1\t0\t10000\n")
    simdir = tmp_path / "simdir"
    simdir.mkdir()
    (simdir / "chr1:0-10000.sim").write_text(tsv.read_text())
    out = ours(["pi", "-b", str(tmp_path / "one.bed"), "--sim-dir",
                str(simdir), "-P", "", "-t", "0.999", "-r", "5",
                "-l", "10000"])
    got = out.splitlines()[-1].split("\t")[-1]
    assert got in want, (got, want)


@pytest.mark.parametrize("seed,method", [(4, "direct"), (5, "grouped"),
                                         (6, "grouped")])
def test_hud_stdout_parity(tmp_path, seed, method):
    tsv, pa, pb = _write_fixture(tmp_path, np.random.default_rng(seed))
    args = [str(tsv), "-a", str(pa), "-b", str(pb), "-m", method,
            "-d", str(tmp_path)]
    if method == "grouped":
        args += ["-t", "0.999"]
    wants = {w.splitlines()[-1]
             for w in _ref_outcomes("hudson/hud.py", *args,
                                    cwd=str(tmp_path))}
    (tmp_path / "one.bed").write_text("chr1\t0\t1000000\n")
    simdir = tmp_path / "simdir"
    simdir.mkdir()
    (simdir / "chr1:0-1000000.sim").write_text(tsv.read_text())
    argv = ["hud", "-b", str(tmp_path / "one.bed"), "--sim-dir", str(simdir),
            "-P", "", "-A", str(pa), "-B", str(pb), "--exact-names",
            "-m", method]
    if method == "grouped":
        argv += ["-t", "0.999"]
    got = ours(argv).splitlines()[-1].split("\t")
    # REGION LENGTH FST PI_A PI_B PI_XY DXY DA per site; hud.py prints
    # FST and the raw sums over the 1e6 bp window
    got_f = [float(got[2])] + [float(x) for x in got[3:8]]

    def close_to(want_line):
        want_f = [float(x) for x in want_line.split("\t")]
        scaled = [want_f[0]] + [x / 1e6 for x in want_f[1:6]]
        return (abs(got_f[0] - scaled[0]) < 2e-3
                and all(abs(g - w) < 5e-8
                        for g, w in zip(got_f[1:], scaled[1:])))

    assert any(close_to(w) for w in wants), (got_f, wants)


def test_af_stdout_parity(tmp_path):
    tsv, _, _ = _write_fixture(tmp_path, np.random.default_rng(9))
    want = _ref("af.py", "--input", str(tsv), "--threshold", "0.999",
                cwd=str(tmp_path))
    assert ours(["afs", "--input", str(tsv), "--threshold", "0.999"]) == want


def test_tjd_stdout_parity(tmp_path):
    from impop_tpu_torch.stats.api import tajimas_d_jit

    want = _ref("tj_d.py", "-n", "446", "-p", "0.59146123", "-S", "20",
                cwd=str(tmp_path))
    got = float(tajimas_d_jit(446.0, 20.0, 0.59146123))
    np.testing.assert_allclose(got, float(want.split()[-1]), rtol=1e-5)
