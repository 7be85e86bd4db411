"""The slice as a whole: ``impop_tpu_torch.cli scan --device cpu`` against
``impop_tpu.cli scan`` on the same inputs, journal resume across the two
packages, and the options the port refuses.

Table comparison: REGION / LENGTH / SAMPLES / SEGREGATING_SITES exact; π
and Tajima's D rtol 1e-5; FST / FSTG / FST3 atol 2e-3; NA in the same
cells."""
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
            if col.startswith("FST"):
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


@pytest.mark.parametrize("flag", [["--ehh"], ["--afs", "x.tsv"],
                                  ["--identity-mode", "columns"],
                                  ["--distributed"]])
def test_unported_options_refuse(paf_inputs, flag):
    _, argv = paf_inputs
    with pytest.raises(SystemExit, match="not ported"):
        torch_main(argv() + flag + ["--device", "cpu"])


def test_cuda_request_without_cuda_raises(paf_inputs):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    _, argv = paf_inputs
    with pytest.raises(RuntimeError, match="cuda"):
        torch_main(argv() + ["--device", "cuda"])
