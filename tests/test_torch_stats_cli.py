"""The per-statistic commands of ``impop_tpu_torch.cli --device cpu`` against
``impop_tpu.cli`` on the same files: ``pi`` (with and without ``-u``,
``-l``, ``-r 5``), ``hfst``, ``hud -m direct|grouped`` (with and without
``--exact-names``), ``fst3pi`` (a window with πC = 0 prints NA), ``afs
--details``, ``panels-hfst`` and ``panels-tajd`` on a metadata directory,
each from ``--sim-dir`` TSVs, ``--geno-dir`` tiles and ``--geno-dir
--identity-mode columns``; the windows walked in device batches smaller
than the BED; window logs; the ``Processed:`` counters with a missing
window; ``--pair-shard on``; and ``cmd_tajd`` called with the
namespace ``panels-tajd`` builds (no ``--stream-npy``).

Tables: integer and text columns equal; π, PI_*, DXY, PICA_OUTPUT and
TAJIMAS_D rtol 1e-5; FST and DA atol 2e-3; NA at the same places.  Logs:
the same keys, integers and text equal, floats as in the tables."""
from __future__ import annotations

import argparse
import json
import os
import re

import numpy as np
import pytest
import torch

import impop_tpu_torch.cli as torch_cli
import impop_tpu_torch.runtime.batcher as torch_batcher
from impop_tpu.cli import main as jax_main
from impop_tpu_torch.cli import cmd_tajd
from impop_tpu_torch.cli import main as torch_main

torch.set_num_threads(1)

SAMPLES = [f"HG{k:05d}" for k in range(14)]
PANELS = {"AFR": SAMPLES[0:4], "AMR": SAMPLES[4:6], "EAS": SAMPLES[6:9],
          "EUR": SAMPLES[9:12], "SAS": SAMPLES[12:14]}
WINDOWS = [(0, 1000), (1000, 2000), (2000, 3000), (3000, 4000)]
MISSING = (2000, 3000)        # no file: skipped, counted as an error
FLAT = (3000, 4000)           # every pair identical: πC = 0


def hap_names():
    return [f"{s}#{h}#ctg" for s in SAMPLES for h in (1, 2)]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Similarity TSVs and allele tiles of the same four windows (one
    missing, one without variation), panel lists, a BED and a metadata
    directory."""
    tmp = tmp_path_factory.mktemp("stats_cli")
    rng = np.random.default_rng(21)
    names = hap_names()
    n = len(names)
    (tmp / "w.bed").write_text("".join(f"chr1\t{lo}\t{hi}\n"
                                       for lo, hi in WINDOWS))
    simdir, genodir = tmp / "sim", tmp / "geno"
    simdir.mkdir()
    genodir.mkdir()
    for lo, hi in WINDOWS:
        if (lo, hi) == MISSING:
            continue
        region = f"CHM13#0#chr1:{lo}-{hi}"
        # similarities with 8 decimals (-r 5 rounds them), a few pairs
        # without data
        cls = rng.integers(0, 5, size=n)
        base = np.where(cls[:, None] == cls[None, :], 0.99955, 0.9962)
        noise = rng.normal(0.0, 0.0004, size=(n, n))
        sim = np.round(np.clip(base + (noise + noise.T) / 2, 0, 1), 8)
        if (lo, hi) == FLAT:
            sim[:] = 1.0
        lines = ["group.a\tgroup.b\testimated.identity"]
        for i in range(n):
            for k in range(i + 1, n):
                if (lo, hi) != FLAT and rng.random() < 0.04:
                    continue
                lines.append(f"{names[i]}\t{names[k]}\t{sim[i, k]:.8f}")
        (simdir / f"{region}.sim").write_text("\n".join(lines) + "\n")
        # allele tiles: class haplotypes with noise and missing calls,
        # rows in unsorted order, two indel keys
        s = 40
        classes = rng.integers(0, 2, size=(4, s)).astype(np.int8)
        geno = classes[rng.integers(0, 4, size=n)]
        geno = np.where(rng.random((n, s)) < 0.02, 1 - geno, geno)
        geno[rng.random((n, s)) < 0.02] = -1
        if (lo, hi) == FLAT:
            geno[:] = 0
        keys = [f"{lo + 10 * c}:A>G" for c in range(s)]
        keys[3], keys[7] = f"{lo + 30}:ACGT>A", f"{lo + 70}:A>ATT"
        perm = rng.permutation(n)
        np.savez(genodir / f"{region}.npz", geno=geno[perm],
                 names=np.asarray(names)[perm], site_keys=np.asarray(keys))
    meta = tmp / "metadata"
    meta.mkdir()
    for pname, samples in PANELS.items():
        (meta / f"agc.{pname}").write_text("\n".join(samples) + "\n")
    # hfst panels that overlap in one sample (stripped from both sides)
    (tmp / "popA.txt").write_text("\n".join(SAMPLES[:7]) + "\n")
    (tmp / "popB.txt").write_text("\n".join(SAMPLES[6:]) + "\n")
    # the same panels as exact sequence names
    (tmp / "exactA.txt").write_text(
        "\n".join(nm for nm in names if nm[:7] in SAMPLES[:7]) + "\n")
    (tmp / "exactB.txt").write_text(
        "\n".join(nm for nm in names if nm[:7] in SAMPLES[7:]) + "\n")
    return tmp


SOURCES = {"sim": lambda d: ["--sim-dir", str(d / "sim")],
           "geno": lambda d: ["--geno-dir", str(d / "geno")],
           "columns": lambda d: ["--geno-dir", str(d / "geno"),
                                 "--identity-mode", "columns"]}

FLOAT_COLS = re.compile(r"^(PI(_.*)?|DXY|PICA_OUTPUT|TAJIMAS_D)$")
FST_COLS = re.compile(r"^(FST|DA)$")


def close(col, va, vb) -> bool:
    if FST_COLS.match(col):
        return abs(float(va) - float(vb)) <= 2e-3
    return bool(np.isclose(float(va), float(vb), rtol=1e-5, atol=1e-8))


def assert_tables_close(path_a, path_b):
    rows_a = [ln.split("\t") for ln in open(path_a).read().splitlines()]
    rows_b = [ln.split("\t") for ln in open(path_b).read().splitlines()]
    assert rows_a[0] == rows_b[0]
    assert len(rows_a) == len(rows_b) > 1
    header = rows_a[0]
    for ra, rb in zip(rows_a[1:], rows_b[1:]):
        assert len(ra) == len(rb) == len(header)
        for col, va, vb in zip(header, ra, rb):
            assert (va == "NA") == (vb == "NA"), (col, ra[0])
            if va == "NA":
                continue
            if col == "PICA_OUTPUT":
                (va, sa), (vb, sb) = va.split(" ", 1), vb.split(" ", 1)
                assert sa == sb
            if FLOAT_COLS.match(col) or FST_COLS.match(col):
                assert close(col, va, vb), (col, ra[0], va, vb)
            else:
                assert va == vb, (col, ra[0])
    return rows_a


def assert_logs_close(dir_a, dir_b):
    files = sorted(os.listdir(dir_a))
    assert files and files == sorted(os.listdir(dir_b))
    for name in files:
        with open(os.path.join(dir_a, name)) as fa, \
                open(os.path.join(dir_b, name)) as fb:
            ta, tb = fa.read(), fb.read()
        assert ta.splitlines()[0] == tb.splitlines()[0]
        ja = json.loads(ta.strip().splitlines()[-1])
        jb = json.loads(tb.strip().splitlines()[-1])
        assert list(ja) == list(jb)
        for key, va in ja.items():
            vb = jb[key]
            if isinstance(va, float) and not isinstance(vb, str):
                if key in ("fst", "da"):
                    assert abs(va - vb) <= 2e-3, (name, key)
                else:
                    assert np.isclose(va, vb, rtol=1e-5, atol=1e-9), (
                        name, key, va, vb)
            else:
                assert va == vb, (name, key)


def counters(err: str):
    return [ln for ln in err.splitlines() if ln.startswith("Processed:")]


def run_both(argv, tmp_path, capsys):
    """The same argv through both packages, with window logs: the same
    logs and counters; returns (jax table, torch table)."""
    out = {}
    for tag, main, extra in (("jax", jax_main, []),
                             ("torch", torch_main, ["--device", "cpu"])):
        args = argv + ["-o", str(tmp_path / f"{tag}.tsv"), "--log-dir",
                       str(tmp_path / f"{tag}_logs")] + extra
        capsys.readouterr()
        assert main(args) == 0
        out[tag] = counters(capsys.readouterr().err)
    assert out["torch"] == out["jax"]
    assert out["jax"] == ["Processed: 4 windows (success: 3, errors: 1)"]
    assert_logs_close(tmp_path / "jax_logs", tmp_path / "torch_logs")
    return tmp_path / "jax.tsv", tmp_path / "torch.tsv"


def base(cmd, inputs, source):
    return [cmd, "-b", str(inputs / "w.bed")] + SOURCES[source](inputs)


@pytest.mark.parametrize("source", ["sim", "geno", "columns"])
@pytest.mark.parametrize("flags", [[], ["-u", "EUR", "-l", "5000",
                                        "-r", "5"]])
def test_pi_matches_jax(inputs, tmp_path, capsys, source, flags):
    flags = [str(inputs / "metadata" / "agc.EUR") if f == "EUR" else f
             for f in flags]
    ja, tb = run_both(base("pi", inputs, source) + flags, tmp_path, capsys)
    rows = assert_tables_close(ja, tb)
    assert len(rows) == 4
    assert float(rows[1][-1].split()[0]) > 0


@pytest.mark.parametrize("cmd,source,exact", [
    (["hfst"], "sim", False), (["hfst"], "sim", True),
    (["hfst"], "geno", False),
    (["hud", "-m", "direct"], "sim", False),
    (["hud", "-m", "direct"], "columns", False),
    (["hud", "-m", "grouped"], "sim", False),
    (["hud", "-m", "grouped"], "sim", True),
    (["hud", "-m", "grouped"], "geno", False),
    (["hud", "-m", "grouped"], "columns", False)])
def test_hudson_matches_jax(inputs, tmp_path, capsys, cmd, source, exact):
    pops = (["-A", str(inputs / "exactA.txt"), "-B",
             str(inputs / "exactB.txt"), "--exact-names"] if exact else
            ["-A", str(inputs / "popA.txt"), "-B", str(inputs / "popB.txt")])
    argv = base(cmd[0], inputs, source) + cmd[1:] + pops
    ja, tb = run_both(argv, tmp_path, capsys)
    rows = assert_tables_close(ja, tb)
    assert float(rows[1][rows[0].index("DXY")]) > 0


@pytest.mark.parametrize("source", ["sim", "geno"])
def test_fst3pi_matches_jax(inputs, tmp_path, capsys, source):
    argv = base("fst3pi", inputs, source) + [
        "-A", str(inputs / "popA.txt"), "-B", str(inputs / "popB.txt"),
        "-r", "5"]
    ja, tb = run_both(argv, tmp_path, capsys)
    rows = assert_tables_close(ja, tb)
    fst = {r[0]: r[-1] for r in rows[1:]}
    assert fst[f"CHM13#0#chr1:{FLAT[0]}-{FLAT[1]}"] == "NA"
    assert fst["CHM13#0#chr1:0-1000"] != "NA"


@pytest.mark.parametrize("cmd", [
    ["pi", "-u", "EUR"], ["hfst"], ["hud", "-m", "grouped"], ["fst3pi"]])
def test_window_batches_match_jax(inputs, tmp_path, capsys, monkeypatch,
                                  cmd):
    """Two windows per device batch (N capacity 64): the three kept
    windows take two batches and print the JAX table."""
    monkeypatch.setattr(torch_cli, "_WINDOW_CHUNK_ELEMS", 2 * 64 * 64)
    sizes = []
    build = torch_batcher.build_window_batch

    def counted(mats, *a, **k):
        sizes.append(len(mats))
        return build(mats, *a, **k)

    monkeypatch.setattr(torch_batcher, "build_window_batch", counted)
    flags = [str(inputs / "metadata" / "agc.EUR") if f == "EUR" else f
             for f in cmd[1:]]
    if cmd[0] != "pi":
        flags += ["-A", str(inputs / "popA.txt"), "-B",
                  str(inputs / "popB.txt")]
    ja, tb = run_both(base(cmd[0], inputs, "sim") + flags, tmp_path, capsys)
    assert sizes == [2, 1]
    assert len(assert_tables_close(ja, tb)) == 4


@pytest.mark.parametrize("threshold", ["1.0", "0.9995"])
def test_afs_matches_jax(inputs, tmp_path, threshold):
    src = inputs / "sim" / "CHM13#0#chr1:0-1000.sim"
    for tag, main, extra in (("jax", jax_main, []),
                             ("torch", torch_main, ["--device", "cpu"])):
        assert main(["afs", "--input", str(src), "--threshold", threshold,
                     "--output", str(tmp_path / f"{tag}.tsv"),
                     "--details", str(tmp_path / f"{tag}.details")]
                    + extra) == 0
    for ext in ("tsv", "details"):
        assert ((tmp_path / f"jax.{ext}").read_text()
                == (tmp_path / f"torch.{ext}").read_text())
    assert len((tmp_path / "torch.tsv").read_text().splitlines()) > 2


def run_in(directory, main, argv):
    directory.mkdir()
    cwd = os.getcwd()
    os.chdir(directory)
    try:
        assert main(argv) == 0
    finally:
        os.chdir(cwd)


def test_panels_hfst_matches_jax(inputs, tmp_path):
    argv = base("panels-hfst", inputs, "sim") + [
        "--metadata-dir", str(inputs / "metadata")]
    run_in(tmp_path / "jax", jax_main, argv)
    run_in(tmp_path / "torch", torch_main, argv + ["--device", "cpu"])
    outputs = sorted(os.listdir(tmp_path / "jax"))
    assert len(outputs) == 10
    assert outputs == sorted(os.listdir(tmp_path / "torch"))
    for name in outputs:
        assert_tables_close(tmp_path / "jax" / name,
                            tmp_path / "torch" / name)


def test_panels_tajd_matches_jax(inputs, tmp_path):
    argv = ["panels-tajd", "-b", str(inputs / "w.bed"), "--geno-dir",
            str(inputs / "geno"), "--metadata-dir",
            str(inputs / "metadata")]
    run_in(tmp_path / "jax", jax_main, argv)
    run_in(tmp_path / "torch", torch_main, argv + ["--device", "cpu"])
    outputs = sorted(os.listdir(tmp_path / "jax"))
    assert outputs == ["afr.tj", "amr.tj", "eas.tj", "eur.tj", "sas.tj"]
    assert outputs == sorted(os.listdir(tmp_path / "torch"))
    for name in outputs:
        rows = assert_tables_close(tmp_path / "jax" / name,
                                   tmp_path / "torch" / name)
        want = 2 * len(PANELS[name[:3].upper()])
        assert {int(r[2]) for r in rows[1:]} == {want}


@pytest.mark.parametrize("cmd", ["tajd", "panels-tajd"])
def test_tajd_batches_match_jax(inputs, tmp_path, capsys, monkeypatch, cmd):
    """Two windows per device batch (N capacity 64): ``tajd`` and
    ``panels-tajd`` walk the three kept windows in batches of 2 + 1 and
    print the JAX tables and counters."""
    import impop_tpu_torch.parallel.scan as torch_scan

    monkeypatch.setattr(torch_cli, "_WINDOW_CHUNK_ELEMS", 2 * 64 * 64)
    sizes = []
    step = torch_scan.batch_tajd_from_alleles

    def counted(geno, *a, **k):
        sizes.append(geno.shape[0])
        return step(geno, *a, **k)

    monkeypatch.setattr(torch_scan, "batch_tajd_from_alleles", counted)
    if cmd == "tajd":
        argv = base("tajd", inputs, "geno")
        errs = {}
        for tag, main, extra in (("jax", jax_main, []),
                                 ("torch", torch_main, ["--device", "cpu"])):
            capsys.readouterr()
            assert main(argv + ["-o", str(tmp_path / f"{tag}.tsv")]
                        + extra) == 0
            errs[tag] = counters(capsys.readouterr().err)
        assert errs["torch"] == errs["jax"] == [
            "Processed: 4 windows (success: 3, errors: 1)"]
        assert sizes == [2, 1]
        assert len(assert_tables_close(tmp_path / "jax.tsv",
                                       tmp_path / "torch.tsv")) == 4
        return
    argv = ["panels-tajd", "-b", str(inputs / "w.bed"), "--geno-dir",
            str(inputs / "geno"), "--metadata-dir",
            str(inputs / "metadata")]
    run_in(tmp_path / "jax", jax_main, argv)
    run_in(tmp_path / "torch", torch_main, argv + ["--device", "cpu"])
    assert sizes == [2, 1] * len(PANELS)
    for name in sorted(os.listdir(tmp_path / "jax")):
        rows = assert_tables_close(tmp_path / "jax" / name,
                                   tmp_path / "torch" / name)
        assert len(rows) == 4


def test_cmd_tajd_without_streaming_flags(inputs, tmp_path):
    """The namespace panels-tajd hands to cmd_tajd has no stream_npy,
    stream_names or chunk_sites."""
    ns = argparse.Namespace(
        bed=str(inputs / "w.bed"), prefix="CHM13#0#", threshold=0.999,
        round=None, log_dir=None, geno_dir=str(inputs / "geno"),
        gfa_dir=None, metadata_dir=str(inputs / "metadata"), length=None,
        samples=str(inputs / "metadata" / "agc.AFR"),
        output=str(tmp_path / "afr.tj"), device="cpu")
    assert cmd_tajd(ns) == 0
    rows = (tmp_path / "afr.tj").read_text().splitlines()
    assert len(rows) == 4 and rows[1].split("\t")[2] == "8"


@pytest.mark.parametrize("method", ["direct", "grouped"])
def test_pair_shard_on_is_refused(inputs, method):
    """``--pair-shard on`` refuses what the JAX command refuses: the
    grouped method, and the direct method without an allele source (it
    splits allele tiles, not similarity matrices)."""
    source, match = (("sim", "needs an allele source") if method == "direct"
                     else ("geno", "direct method only"))
    argv = base("hud", inputs, source) + [
        "-m", method, "-A", str(inputs / "popA.txt"), "-B",
        str(inputs / "popB.txt"), "--pair-shard", "on", "--device", "cpu"]
    with pytest.raises(SystemExit, match=match):
        torch_main(argv)
