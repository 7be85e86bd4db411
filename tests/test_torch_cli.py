"""The slice as a whole: ``impop_tpu_torch.cli scan --device cpu`` against
``impop_tpu.cli scan`` on the same inputs (with ``--ehh``, ``--ehh-focal``,
``--afs`` and ``--identity-mode columns``, alone and combined), journal
resume across the two packages, and the option the port refuses.

Table comparison: REGION / LENGTH / SAMPLES / SEGREGATING_SITES,
EHH_FOCAL and EHH_CARR_* exact; π, Tajima's D and EHH areas rtol 1e-5;
FST / FSTG / FST3 atol 2e-3; NA in the same cells.  Spectrum files
byte-identical."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from impop_tpu.cli import main as jax_main
from impop_tpu_torch.cli import main as torch_main

torch.set_num_threads(1)


def read_table(path):
    lines = [ln.split("\t") for ln in path.read_text().splitlines() if ln]
    return lines[0], lines[1:]


def assert_tables_close(path_a, path_b):
    head_a, rows_a = read_table(path_a)
    head_b, rows_b = read_table(path_b)
    assert head_a == head_b
    assert len(rows_a) == len(rows_b)
    for ra, rb in zip(rows_a, rows_b):
        assert ra[:4] == rb[:4]
        for col, va, vb in zip(head_a[4:], ra[4:], rb[4:]):
            assert (va == "NA") == (vb == "NA"), (col, ra[0])
            if va == "NA":
                continue
            if col == "EHH_FOCAL" or col.startswith("EHH_CARR"):
                assert va == vb, (col, ra[0])
            elif col.startswith("FST"):
                assert abs(float(va) - float(vb)) <= 2e-3, (col, va, vb)
            else:
                np.testing.assert_allclose(float(va), float(vb), rtol=1e-5,
                                           atol=1e-8, err_msg=col)


@pytest.fixture(scope="module")
def paf_inputs(tmp_path_factory):
    from impop_tpu.extract.simulate import simulate

    tmp = tmp_path_factory.mktemp("torch_scan")
    sim = simulate(str(tmp), ref_len=6000, n_haps=10, seed=5, site_pool=40,
                   span=(0, 6000))
    (tmp / "w.bed").write_text("chr1\t0\t1500\nchr1\t1000\t2500\n"
                               "chr1\t2500\t4000\nchr1\t4000\t6000\n")
    (tmp / "w2.bed").write_text("chr1\t0\t1500\nchr1\t1000\t2500\n")
    # P3 overlaps P1 (HG00902): the non-disjoint program
    (tmp / "agc.P1").write_text("HG00900\nHG00901\nHG00902\n")
    (tmp / "agc.P2").write_text("HG00903\nHG00904\n")
    (tmp / "agc.P3").write_text("HG00902\nHG00905\n")
    (tmp / "focal.txt").write_text("# chrom pos\nchr1 3000\nchr1 4100\n")

    def argv(bed="w.bed", panels=("P1", "P2", "P3")):
        args = ["scan", "-b", str(tmp / bed), "--paf", sim.paf_path,
                "--fasta", sim.fasta_path, "-P", "CHM13#0#", "--batch", "2"]
        for p in panels:
            args += ["--panel", str(tmp / f"agc.{p}")]
        return args

    return tmp, argv


@pytest.mark.parametrize("panels", [("P1", "P2", "P3"), ("P1", "P2")])
def test_scan_table_matches_jax(paf_inputs, tmp_path, panels):
    _, argv = paf_inputs
    out_j, out_t = tmp_path / "jax.tsv", tmp_path / "torch.tsv"
    assert jax_main(argv(panels=panels) + ["-o", str(out_j)]) == 0
    assert torch_main(argv(panels=panels) + ["-o", str(out_t),
                                             "--device", "cpu"]) == 0
    assert_tables_close(out_j, out_t)
    assert len(read_table(out_t)[1]) == 4


def test_scan_geno_dir_partial_coverage_matches_jax(tmp_path):
    """The seed_risk window of tests/test_cli.py: both packages recompute
    its FSTG exactly (hud.py -m grouped gives 1.0 there)."""
    genodir = tmp_path / "genodir"
    genodir.mkdir()
    geno = np.full((4, 8), -1, np.int8)
    geno[0, :4] = [1, 0, 1, 0]
    geno[1] = [1, 0, 1, 0, 0, 0, 0, 1]
    geno[2, 4:] = [1, 1, 0, 0]
    geno[3] = [0, 1, 1, 0, 1, 1, 0, 0]
    names = [f"h{i:02d}#1#c{i}" for i in range(4)]
    np.savez(genodir / "chr1:0-1000.npz", geno=geno, names=np.asarray(names))
    (tmp_path / "w.bed").write_text("chr1\t0\t1000\n")
    (tmp_path / "A.txt").write_text("h00\nh01\n")
    (tmp_path / "B.txt").write_text("h02\nh03\n")
    args = ["scan", "-b", str(tmp_path / "w.bed"), "-P", "",
            "--geno-dir", str(genodir),
            "--panel", str(tmp_path / "A.txt"),
            "--panel", str(tmp_path / "B.txt")]
    out_j, out_t = tmp_path / "jax.tsv", tmp_path / "torch.tsv"
    assert jax_main(args + ["-o", str(out_j)]) == 0
    assert torch_main(args + ["-o", str(out_t), "--device", "cpu"]) == 0
    assert_tables_close(out_j, out_t)
    header, rows = read_table(out_t)
    assert float(rows[0][header.index("FSTG_A_B")]) == 1.0


@pytest.mark.parametrize("first,second", [("jax", "torch"),
                                          ("torch", "jax")])
def test_journal_resumes_across_packages(paf_inputs, tmp_path, first,
                                         second):
    """One package journals the first two windows; the other resumes the
    full scan: the journaled rows come back verbatim and the rest agree
    with a clean run of the first package."""
    _, argv = paf_inputs
    run = {"jax": lambda a: jax_main(a),
           "torch": lambda a: torch_main(a + ["--device", "cpu"])}
    journal = tmp_path / "scan.jsonl"
    part, full, clean = (tmp_path / f"{k}.tsv"
                         for k in ("part", "full", "clean"))
    assert run[first](argv("w2.bed") + ["--journal", str(journal), "-o",
                                        str(part)]) == 0
    assert run[second](argv() + ["--journal", str(journal), "-o",
                                 str(full)]) == 0
    assert run[first](argv() + ["-o", str(clean)]) == 0
    _, rows_part = read_table(part)
    _, rows_full = read_table(full)
    assert rows_full[:2] == rows_part
    assert_tables_close(clean, full)
    # a second resume replays every row
    again = tmp_path / "again.tsv"
    assert run[first](argv() + ["--journal", str(journal), "-o",
                                str(again)]) == 0
    assert again.read_text() == full.read_text()


def run_both(args, tmp_path, extra):
    """The same scan through both packages; ``AFS`` in ``extra`` names a
    spectrum file per package.  Returns the (jax, torch) output paths."""
    outs = {}
    for pkg, run in (("jax", jax_main),
                     ("torch", lambda a: torch_main(a + ["--device",
                                                         "cpu"]))):
        tsv, afs = tmp_path / f"{pkg}.tsv", tmp_path / f"{pkg}.afs"
        flags = [str(afs) if f == "AFS" else f for f in extra]
        assert run(args + flags + ["-o", str(tsv)]) == 0
        outs[pkg] = (tsv, afs)
    assert_tables_close(outs["jax"][0], outs["torch"][0])
    if "AFS" in extra:
        assert outs["torch"][1].read_bytes() == outs["jax"][1].read_bytes()
    return outs


OPTION_CASES = {
    "ehh": ["--ehh"],
    "ehh-focal": ["--ehh", "--ehh-focal", "FOCAL"],
    "afs": ["--afs", "AFS"],
    "columns": ["--identity-mode", "columns"],
    "columns-ehh": ["--identity-mode", "columns", "--ehh"],
}


@pytest.mark.parametrize("case", list(OPTION_CASES))
def test_scan_options_match_jax(paf_inputs, tmp_path, case):
    tmp, argv = paf_inputs
    extra = [str(tmp / "focal.txt") if f == "FOCAL" else f
             for f in OPTION_CASES[case]]
    outs = run_both(argv(), tmp_path, extra)
    header, rows = read_table(outs["torch"][0])
    assert len(rows) == 4
    if "--ehh" in extra:
        assert header[-5:] == ["EHH_FOCAL", "EHH_AREA_REF", "EHH_CARR_REF",
                               "EHH_AREA_ALT", "EHH_CARR_ALT"]
        assert all(r[-5] != "NA" for r in rows)
    if case == "ehh-focal":
        # the 4100 target moves the last window's focal off its midpoint
        (tmp_path / "plain").mkdir()
        plain = run_both(argv(), tmp_path / "plain", ["--ehh"])
        _, rows_plain = read_table(plain["torch"][0])
        assert rows[3][-5] != rows_plain[3][-5]


@pytest.fixture
def genodir_inputs(tmp_path):
    """A seed_risk window (two coverage islands) and a 12-haplotype window,
    both with site keys (SNPs and indels), for the --geno-dir path."""
    rng = np.random.default_rng(3)
    genodir = tmp_path / "genodir"
    genodir.mkdir()
    geno = np.full((4, 8), -1, np.int8)
    geno[0, :4] = [1, 0, 1, 0]
    geno[1] = [1, 0, 1, 0, 0, 0, 0, 1]
    geno[2, 4:] = [1, 1, 0, 0]
    geno[3] = [0, 1, 1, 0, 1, 1, 0, 0]
    keys = ["10:A>G", "20:C>CTT", "30:G>T", "40:ACGT>A", "50:T>C",
            "60:G>GAAAAA", "70:C>A", "80:T><INS9>"]
    np.savez(genodir / "chr1:0-1000.npz", geno=geno,
             names=np.asarray([f"h{i:02d}#1#c{i}" for i in range(4)]),
             site_keys=np.asarray(keys))
    base = rng.integers(0, 2, size=(3, 30)).astype(np.int8)
    geno2 = base[rng.integers(0, 3, size=12)]
    geno2 = np.where(rng.random((12, 30)) < 0.05, 1 - geno2, geno2)
    geno2[rng.random((12, 30)) < 0.05] = -1
    keys2 = [f"{1000 + 30 * k}:{'A' * (1 + k % 4)}>G" for k in range(30)]
    np.savez(genodir / "chr1:1000-2000.npz", geno=geno2.astype(np.int8),
             names=np.asarray([f"h{i:02d}#1#c{i}" for i in range(12)]),
             site_keys=np.asarray(keys2))
    (tmp_path / "w.bed").write_text("chr1\t0\t1000\nchr1\t1000\t2000\n")
    (tmp_path / "A.txt").write_text("h00\nh01\nh04\nh05\nh06\n")
    (tmp_path / "B.txt").write_text("h02\nh03\nh07\nh08\nh09\n")
    (tmp_path / "focal.txt").write_text("chr1 55\n")
    return ["scan", "-b", str(tmp_path / "w.bed"), "-P", "",
            "--geno-dir", str(genodir), "--panel", str(tmp_path / "A.txt"),
            "--panel", str(tmp_path / "B.txt")], tmp_path / "focal.txt"


@pytest.mark.parametrize("extra", [
    ["--ehh"],
    ["--identity-mode", "columns", "--ehh", "--ehh-focal", "FOCAL"],
    ["--afs", "AFS", "--afs-unfolded"],
])
def test_scan_geno_dir_options_match_jax(genodir_inputs, tmp_path, extra):
    """The tiles path: weights from the site keys, focals from their
    positions, and the seed_risk window's exact FSTG recompute on an
    --ehh (4 bytes longer) wire row."""
    args, focal = genodir_inputs
    extra = [str(focal) if f == "FOCAL" else f for f in extra]
    (tmp_path / "out").mkdir()
    outs = run_both(args, tmp_path / "out", extra)
    header, rows = read_table(outs["torch"][0])
    assert float(rows[0][header.index("FSTG_A_B")]) == 1.0
    if "--ehh-focal" in extra:
        assert rows[0][header.index("EHH_FOCAL")] == "50"


@pytest.mark.parametrize("first,second", [("jax", "torch"),
                                          ("torch", "jax")])
def test_journal_resume_with_afs_across_packages(paf_inputs, tmp_path,
                                                 first, second):
    """A resumed --afs scan merges the journaled windows' spectra: its
    spectrum file equals a clean run's, byte for byte."""
    _, argv = paf_inputs
    run = {"jax": lambda a: jax_main(a),
           "torch": lambda a: torch_main(a + ["--device", "cpu"])}
    journal = tmp_path / "scan.jsonl"

    def afs(name):
        return ["--afs", str(tmp_path / f"{name}.afs"), "--ehh"]

    assert run[first](argv("w2.bed") + afs("part") + [
        "--journal", str(journal), "-o", str(tmp_path / "part.tsv")]) == 0
    assert run[second](argv() + afs("full") + [
        "--journal", str(journal), "-o", str(tmp_path / "full.tsv")]) == 0
    assert run[first](argv() + afs("clean") + [
        "-o", str(tmp_path / "clean.tsv")]) == 0
    assert_tables_close(tmp_path / "clean.tsv", tmp_path / "full.tsv")
    assert ((tmp_path / "full.afs").read_bytes()
            == (tmp_path / "clean.afs").read_bytes())


@pytest.mark.parametrize("flag", [["--distributed"]])
def test_unported_options_refuse(paf_inputs, flag, monkeypatch):
    """``--distributed`` runs (tests/test_torch_distributed.py); without a
    process group's environment it refuses, naming what it needs."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    _, argv = paf_inputs
    with pytest.raises(SystemExit, match="MASTER_ADDR, MASTER_PORT, RANK, "
                                         "WORLD_SIZE"):
        torch_main(argv() + flag + ["--device", "cpu"])


def test_cuda_request_without_cuda_raises(paf_inputs):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    _, argv = paf_inputs
    with pytest.raises(RuntimeError, match="cuda"):
        torch_main(argv() + ["--device", "cuda"])
