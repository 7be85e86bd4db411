"""The port's host-only commands against their JAX originals on the same
inputs: ``spectrum`` (``--no-plots``, ``--compat-first-allele``,
``--first-site-col``, and with its PNGs), ``makewindows``,
``merge-parts`` (tables and ``--sum``, with ``--remove``), ``extract``
(per window, ``--split``, ``--python``, ``--vcf``, ``--gfa``),
``gfasim``, ``gfa2vcf`` (with ``--npz``), ``import-agc`` (``--list``,
``--samples``, ``--prefix-sample``, ``--verify``, ``--index``, through the
stand-in ``agc`` of ``tests/test_agc.py``), ``scan`` and ``pi`` on an AGC
archive (the twins of ``test_agc.py``'s driver tests) and ``plot``.  Text files are
compared byte for byte, ``.npz`` tiles array by array, gzip stores by
their text, and PNGs by being written."""
from __future__ import annotations

import gzip
import os
import stat
import sys

import numpy as np
import pytest
import torch

from impop_tpu.cli import main as jax_main
from impop_tpu_torch.cli import main as torch_main
from impop_tpu_torch.extract.pyfallback import read_fasta
from impop_tpu_torch.hostio import simulate
from impop_tpu_torch.report import tables
from test_torch_cli import assert_tables_close

torch.set_num_threads(1)


def both(root, argv_for):
    """Run ``argv_for(side_dir)`` through each package, each in its own
    directory under ``root``; returns the two directories."""
    dirs = {}
    for side, main in (("jax", jax_main), ("torch", torch_main)):
        d = root / side
        d.mkdir(parents=True, exist_ok=True)
        assert main(argv_for(d)) == 0
        dirs[side] = d
    return dirs["jax"], dirs["torch"]


def same_tree(a, b):
    """Every file of ``a`` in ``b`` with the same content (.npz by array,
    .gz by text; a PAF index sidecar, which records its PAF's mtime, by
    name only)."""
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for name in names:
        pa, pb = os.path.join(a, name), os.path.join(b, name)
        if name.endswith(".impopidx"):
            continue
        if name.endswith(".npz"):
            za, zb = np.load(pa), np.load(pb)
            assert sorted(za.files) == sorted(zb.files)
            for key in za.files:
                np.testing.assert_array_equal(za[key], zb[key])
        elif name.endswith(".gz"):
            with gzip.open(pa, "rt") as fa, gzip.open(pb, "rt") as fb:
                assert fa.read() == fb.read(), name
        else:
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                assert fa.read() == fb.read(), name


# --------------------------------------------------------------- spectrum


@pytest.fixture
def site_table(tmp_path):
    rng = np.random.default_rng(3)
    sites = [f"s{k}" for k in range(12)]
    path = tmp_path / "sites.tsv"
    with open(path, "w") as fh:
        fh.write("\t".join(["sample", "chrom", "hap", *sites]) + "\n")
        for r in range(9):
            calls = rng.choice(["0", "1", "2"], size=len(sites),
                               p=[0.6, 0.3, 0.1])
            calls[0] = "1"                    # s0 monomorphic
            fh.write("\t".join([f"h{r}", "chr1", "1", *calls]) + "\n")
        fh.write("short\trow\n")              # skipped: wrong width
    return str(path)


@pytest.mark.parametrize("flags", [[], ["--compat-first-allele"],
                                   ["--first-site-col", "5"]])
def test_spectrum_table_equals_jax(tmp_path, site_table, flags):
    ja, to = both(tmp_path, lambda d: [
        "spectrum", "--input", site_table, "-o", str(d / "spec.tsv"),
        "--no-plots", *flags])
    same_tree(ja, to)
    assert len((to / "spec.tsv").read_text().splitlines()) > 5


def test_spectrum_plots(tmp_path, site_table):
    ja, to = both(tmp_path, lambda d: [
        "spectrum", "--input", site_table, "-o", str(d / "spec.tsv"),
        "--counts-png", str(d / "counts.png"),
        "--freqs-png", str(d / "freqs.png")])
    assert (ja / "spec.tsv").read_text() == (to / "spec.tsv").read_text()
    for name in ("counts.png", "freqs.png"):
        assert (to / name).stat().st_size > 1000
        assert (ja / name).exists()


# --------------------------------------------------------------- utilities


@pytest.mark.parametrize("how", ["region", "bed"])
def test_makewindows_equals_jax(tmp_path, how):
    bed = tmp_path / "base.bed"
    bed.write_text("chr1\t0\t1000\nchr2\t500\t1750\n")
    src = (["--region", "chr1:100:2350"] if how == "region"
           else ["--bed", str(bed)])
    ja, to = both(tmp_path, lambda d: [
        "makewindows", *src, "-w", "400", "-o", str(d / "w.bed")])
    same_tree(ja, to)


@pytest.mark.parametrize("mode", ["tables", "sum"])
def test_merge_parts_equals_jax(tmp_path, mode):
    def argv_for(d):
        for k in (0, 1, 2, 10):
            with open(d / f"out.tsv.part{k}", "w") as fh:
                if mode == "sum":
                    fh.write("ALLELE_COUNT\tSITES_A\tSITES_B\n")
                    for j in range(1, 4 + k % 3):
                        fh.write(f"{j}\t{j * k}\t{k + 1}\n")
                else:
                    fh.write("REGION\tPI\n")
                    fh.write(f"chr1:{k}-{k + 1}\t0.{k}\n")
        return (["merge-parts", str(d / "out.tsv"), "--remove"]
                + (["--sum"] if mode == "sum" else []))

    ja, to = both(tmp_path, argv_for)
    same_tree(ja, to)
    assert os.listdir(to) == ["out.tsv"]


# --------------------------------------------------------------- extract


@pytest.fixture(scope="module")
def pangenome(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("hostcmds")
    sim = simulate(str(tmp), ref_len=3000, n_haps=6, seed=29, site_pool=20,
                   span=(0, 3000))
    bed = tmp / "w.bed"
    bed.write_text("chr1\t0\t1500\nchr1\t1500\t3000\nchr9\t0\t100\n")
    return sim, str(bed)


@pytest.mark.parametrize("flags", [[], ["--vcf", "--gfa"],
                                   ["--split", "500", "--vcf"],
                                   ["--python"]])
def test_extract_equals_jax(tmp_path, pangenome, flags):
    sim, bed = pangenome
    ja, to = both(tmp_path, lambda d: [
        "extract", "-b", bed, "--paf", sim.paf_path, "--fasta",
        sim.fasta_path, "-P", "CHM13#0#", "--out-dir", str(d / "tiles"),
        *flags])
    same_tree(ja / "tiles", to / "tiles")
    n_tiles = 7 if "--split" in flags else 3     # chr9 gives an empty tile
    assert len(list((to / "tiles").glob("*.npz"))) == n_tiles


def test_gfasim_and_gfa2vcf_equal_jax(tmp_path, pangenome):
    sim, bed = pangenome
    tiles = tmp_path / "tiles"
    assert torch_main(["extract", "-b", bed, "--paf", sim.paf_path,
                       "--fasta", sim.fasta_path, "-P", "CHM13#0#",
                       "--out-dir", str(tiles), "--gfa"]) == 0
    gfa = str(tiles / "CHM13_0_chr1_0_1500.gfa")
    ja, to = both(tmp_path, lambda d: ["gfasim", gfa, "-o",
                                       str(d / "sim.tsv")])
    ja2, to2 = both(tmp_path / "vcf", lambda d: [
        "gfa2vcf", gfa, "-o", str(d / "w.vcf"), "--npz", str(d / "w.npz")])
    same_tree(ja, to)
    same_tree(ja2, to2)
    assert len([ln for ln in (to2 / "w.vcf").read_text().splitlines()
                if not ln.startswith("#")]) > 0


# --------------------------------------------------------------- import-agc

# the stand-in ``agc`` of tests/test_agc.py: listset / getset / getcol over
# a staging directory of per-sample FASTAs
FAKE_AGC = """#!{python}
import os, sys
root = os.path.dirname(os.path.abspath(__file__))
store = os.path.join(root, "agc_store")
cmd = sys.argv[1]
samples = sorted(os.listdir(store))
if cmd == "listset":
    for s in samples:
        print(os.path.splitext(s)[0])
elif cmd == "getset":
    want = sys.argv[3]
    with open(os.path.join(store, want + ".fa")) as fh:
        sys.stdout.write(fh.read())
elif cmd == "getcol":
    for s in samples:
        with open(os.path.join(store, s)) as fh:
            sys.stdout.write(fh.read())
else:
    sys.exit(2)
"""


@pytest.fixture
def fake_agc(tmp_path, monkeypatch):
    """FAKE_AGC on PATH, serving the simulator's sequences."""
    sim = simulate(str(tmp_path), ref_len=2000, n_haps=6, n_snps=8, seed=31,
                   span=(0, 2000))
    store = tmp_path / "agc_store"
    store.mkdir()
    for name, seq in read_fasta(sim.fasta_path).items():
        with open(store / f"{name.replace('#', '_')}.fa", "w") as fh:
            fh.write(f">{name}\n")
            for i in range(0, len(seq), 60):
                fh.write(seq[i:i + 60] + "\n")
    agc_bin = tmp_path / "agc"
    agc_bin.write_text(FAKE_AGC.format(python=sys.executable))
    agc_bin.chmod(agc_bin.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}" + os.environ["PATH"])
    archive = tmp_path / "assemblies.agc"
    archive.write_bytes(b"AGC\x03fake")
    return sim, str(archive)


def test_import_agc_equals_jax(tmp_path, fake_agc, capsys):
    sim, archive = fake_agc
    listing = tmp_path / "names.txt"
    listing.write_text("\n".join(sorted(
        n.replace("#", "_") for n in read_fasta(sim.fasta_path))[:2]) + "\n")
    ja, to = both(tmp_path, lambda d: [
        "import-agc", archive, "-o", str(d / "store.fa.gz"), "--verify",
        "--index"])
    same_tree(ja, to)
    ja, to = both(tmp_path / "subset", lambda d: [
        "import-agc", archive, "-o", str(d / "sub.fa.gz"), "--samples",
        str(listing), "--prefix-sample"])
    same_tree(ja, to)
    capsys.readouterr()
    listed = []
    for main in (jax_main, torch_main):
        assert main(["import-agc", archive, "--list"]) == 0
        listed.append(capsys.readouterr().out)
    assert listed[0] == listed[1] and len(listed[1].splitlines()) == 7


def test_scan_with_agc_runs_natively(fake_agc, tmp_path):
    """scan --paf --agc (the twin of tests/test_agc.py's): one cached
    conversion, then native extraction; the second run reuses the cache.
    The table is the JAX scan's on the same archive (the tolerances of
    ``test_torch_cli.assert_tables_close``)."""
    sim, archive = fake_agc
    bed = tmp_path / "w.bed"
    bed.write_text("chr1\t0\t1000\nchr1\t1000\t2000\n")
    argv = ["scan", "-b", str(bed), "--paf", sim.paf_path, "--agc", archive,
            "-P", "CHM13#0#"]
    out = tmp_path / "scan.tsv"
    assert torch_main(argv + ["-o", str(out), "--device", "cpu"]) == 0
    lines = [ln for ln in out.read_text().splitlines() if ln]
    assert len(lines) == 3
    row = lines[1].split("\t")
    assert int(row[2]) == 7          # 6 haplotypes + the reference row
    assert int(row[3]) > 0           # segregating sites flowed through
    cache = archive + ".impop.fa.gz"
    assert os.path.exists(cache)
    mtime = os.path.getmtime(cache)
    assert jax_main(argv + ["-o", str(tmp_path / "jax.tsv")]) == 0
    assert os.path.getmtime(cache) == mtime
    assert_tables_close(tmp_path / "jax.tsv", out)


def test_pi_with_agc_matches_fasta_path(fake_agc, tmp_path):
    """pi --paf --agc == pi --paf --fasta on the port, and both equal the
    JAX table."""
    sim, archive = fake_agc
    bed = tmp_path / "w.bed"
    bed.write_text("chr1\t0\t2000\n")
    base = ["pi", "-b", str(bed), "--paf", sim.paf_path, "-P", "CHM13#0#",
            "-t", "0.999"]
    outs = []
    for main, src, extra in ((torch_main, ["--agc", archive], ["--device",
                                                               "cpu"]),
                             (torch_main, ["--fasta", sim.fasta_path],
                              ["--device", "cpu"]),
                             (jax_main, ["--agc", archive], [])):
        outs.append(tmp_path / f"pi{len(outs)}.tsv")
        assert main(base + src + ["-o", str(outs[-1])] + extra) == 0
    texts = [p.read_text() for p in outs]
    assert texts[0] == texts[1] == texts[2]
    assert len(texts[0].splitlines()) == 2


# --------------------------------------------------------------- plot


@pytest.mark.parametrize("kind", ["pi", "fst", "tajd"])
def test_plot_writes_the_png(tmp_path, kind):
    table = tmp_path / f"t.{kind}"
    with open(table, "w") as fh:
        if kind == "pi":
            fh.write(tables.pi_table_header(with_subset=True) + "\n")
        else:
            fh.write((tables.HFST_HEADER if kind == "fst"
                      else tables.TAJD_HEADER) + "\n")
        for i in range(6):
            region = f"CHM13#0#chr{1 + i // 3}:{i * 500}-{(i + 1) * 500}"
            if kind == "pi":
                pica = tables.format_pica_output(0.001, 2e-6 * (i + 1), 500)
                fh.write(tables.pi_row(region, "EUR", 500, 0.999, 5, pica)
                         + "\n")
            elif kind == "fst":
                fh.write(tables.hfst_row(region, 500, 0.1 * i, 0.01, 0.02,
                                         0.015, 0.03, 0.004) + "\n")
            else:
                fh.write(tables.tajd_row(region, 500, 10, 4 + i, 0.002,
                                         -0.5 + 0.2 * i) + "\n")
    ja, to = both(tmp_path, lambda d: [
        "plot", kind, "--input", f"A={table}", "--output",
        str(d / "trend.png"), "--highlight", "chr1:100-900",
        "--title", "t"])
    assert (to / "trend.png").stat().st_size > 1000
    assert (ja / "trend.png").exists()
