"""The dealt scan on the CPU: ``impop_tpu_torch.cli scan --device cpu`` with
``parallel.distributed.process_devices`` patched to three CPU entries
(three distinct ``torch.device("cpu")`` objects), so that chunk k of the
windows goes, whole, to entry k mod 3.

- The table, the journal, the ``--afs`` spectrum and the ``--log-dir``
  files are byte-identical to the one-device scan's, for the plain scan
  and for ``--identity-mode columns --ehh --afs``, on allele tiles
  (``--geno-dir``, with seed_risk windows that take the exact FSTG
  recompute, and a short last chunk whose padding row is dropped) and on
  the PAF extractor.
- Entry i gets exactly the chunks k with k = i mod 3: each dealt wire
  batch is stepped once (``scan_step``), and the exact recompute runs on
  the batch's own wire.
- The table stays within ``tests/test_torch_cli.py``'s budget of the JAX
  ``scan`` (integers exact, π / D / EHH areas rtol 1e-5, Fst atol 2e-3)
  and the spectrum equals the JAX one byte for byte.
- A journal begun by a dealt scan resumes in a one-device scan.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import impop_tpu_torch.parallel.distributed as dist_mod
from impop_tpu.cli import main as jax_main
from impop_tpu_torch import scanstep
from impop_tpu_torch.cli import main as torch_main
from impop_tpu_torch.hostio import simulate
from test_torch_cli import assert_tables_close, read_table

torch.set_num_threads(1)
N_ENTRIES = 3
N_TILE_WINDOWS = 15           # --batch 2: 8 chunks, the last one short
N_PAF_WINDOWS = 8             # --batch 1: 8 chunks
RISK_WINDOWS = (0, 7, 14)     # two coverage islands: seed_risk is set

OPTION_SETS = {"plain": [],
               "columns-ehh-afs": ["--identity-mode", "columns", "--ehh",
                                   "--afs", "AFS"]}


def risk_tile():
    geno = np.full((4, 8), -1, np.int8)
    geno[0, :4] = [1, 0, 1, 0]
    geno[1] = [1, 0, 1, 0, 0, 0, 0, 1]
    geno[2, 4:] = [1, 1, 0, 0]
    geno[3] = [0, 1, 1, 0, 1, 1, 0, 0]
    return geno


@pytest.fixture(scope="module")
def tiles_source(tmp_path_factory):
    """15 windows of allele tiles with site keys: 4-haplotype seed_risk
    windows at 0, 7 and 14, the rest 12 to 20 haplotypes of clustered
    calls with missing data."""
    tmp = tmp_path_factory.mktemp("deal_tiles")
    genodir = tmp / "genodir"
    genodir.mkdir()
    rng = np.random.default_rng(41)
    bed = []
    for k in range(N_TILE_WINDOWS):
        lo = k * 1000
        if k in RISK_WINDOWS:
            geno = risk_tile()
        else:
            n, s = int(rng.integers(12, 21)), int(rng.integers(20, 60))
            base = rng.integers(0, 2, size=(4, s)).astype(np.int8)
            geno = base[rng.integers(0, 4, size=n)]
            geno = np.where(rng.random((n, s)) < 0.05, 1 - geno, geno)
            geno[rng.random((n, s)) < 0.05] = -1
        n, s = geno.shape
        keys = [f"{lo + 10 * (j + 1)}:{'A' * (1 + j % 4)}>G"
                for j in range(s)]
        np.savez(genodir / f"chr1:{lo}-{lo + 1000}.npz",
                 geno=geno.astype(np.int8),
                 names=np.asarray([f"h{i:02d}#1#c{i}" for i in range(n)]),
                 site_keys=np.asarray(keys))
        bed.append(f"chr1\t{lo}\t{lo + 1000}\n")
    (tmp / "w.bed").write_text("".join(bed))
    (tmp / "w6.bed").write_text("".join(bed[:6]))
    (tmp / "A.txt").write_text("h00\nh01\nh04\nh05\nh06\nh12\nh13\n")
    (tmp / "B.txt").write_text("h02\nh03\nh07\nh08\nh09\nh14\n")
    (tmp / "C.txt").write_text("h10\nh11\nh15\nh16\n")

    def argv(bed="w.bed"):
        return ["scan", "-b", str(tmp / bed), "-P", "", "--geno-dir",
                str(genodir), "--panel", str(tmp / "A.txt"), "--panel",
                str(tmp / "B.txt"), "--panel", str(tmp / "C.txt"),
                "--batch", "2"]

    return argv


@pytest.fixture(scope="module")
def paf_source(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("deal_paf")
    span = 1000 * N_PAF_WINDOWS
    sim = simulate(str(tmp), ref_len=span, n_haps=10, seed=5, site_pool=60,
                   span=(0, span))
    (tmp / "w.bed").write_text("".join(
        f"chr1\t{k * 1000}\t{(k + 1) * 1000}\n"
        for k in range(N_PAF_WINDOWS)))
    (tmp / "agc.P1").write_text("HG00900\nHG00901\nHG00902\n")
    (tmp / "agc.P2").write_text("HG00903\nHG00904\n")

    def argv(bed="w.bed"):
        return ["scan", "-b", str(tmp / bed), "--paf", sim.paf_path,
                "--fasta", sim.fasta_path, "-P", "CHM13#0#", "--panel",
                str(tmp / "agc.P1"), "--panel", str(tmp / "agc.P2"),
                "--batch", "1"]

    return argv


class DealSpy:
    """``process_devices`` -> ``n`` distinct CPU entries; records which
    entry each dealt wire batch went to, and the wire of every step and
    exact recompute."""

    def __init__(self, monkeypatch, n):
        self.devs = [torch.device("cpu") for _ in range(n)]
        self.dealt, self.stepped, self.exact = [], [], []
        monkeypatch.setattr(dist_mod, "process_devices",
                            lambda name: self.devs)
        real_deal = scanstep.deal_wire
        real_step = scanstep.scan_step
        real_exact = scanstep.scan_step_fstg_exact

        def deal(flat, dev):
            wire = real_deal(flat, dev)
            self.dealt.append(
                (next(i for i, d in enumerate(self.devs) if d is dev), wire))
            return wire

        def step(flat, *args, **kwargs):
            self.stepped.append(flat)
            return real_step(flat, *args, **kwargs)

        def exact(flat, *args, **kwargs):
            self.exact.append(flat)
            return real_exact(flat, *args, **kwargs)

        monkeypatch.setattr(scanstep, "deal_wire", deal)
        monkeypatch.setattr(scanstep, "scan_step", step)
        monkeypatch.setattr(scanstep, "scan_step_fstg_exact", exact)

    def check(self, n_chunks):
        assert [i for i, _ in self.dealt] == [k % len(self.devs)
                                              for k in range(n_chunks)]
        assert len(self.stepped) == n_chunks
        for (_, wire), flat in zip(self.dealt, self.stepped):
            assert flat is wire
        dealt = [wire for _, wire in self.dealt]
        for flat in self.exact:
            assert any(flat is wire for wire in dealt)


def run_scan(argv, out_dir, extra, main=torch_main):
    """One scan writing table, spectrum and (the port's) journal and window
    logs under ``out_dir``; returns their paths."""
    out_dir.mkdir()
    paths = {"tsv": out_dir / "scan.tsv", "journal": out_dir / "scan.jsonl",
             "afs": out_dir / "scan.afs", "logs": out_dir / "logs"}
    flags = [str(paths["afs"]) if f == "AFS" else f for f in extra]
    cmd = argv + flags + ["-o", str(paths["tsv"])]
    if main is torch_main:
        cmd += ["--journal", str(paths["journal"]), "--log-dir",
                str(paths["logs"]), "--device", "cpu"]
    assert main(cmd) == 0
    return paths


def assert_same_outputs(a, b, with_afs):
    for key in ("tsv", "journal"):
        assert a[key].read_bytes() == b[key].read_bytes(), key
    if with_afs:
        assert a["afs"].read_bytes() == b["afs"].read_bytes()
    logs_a = sorted(p.name for p in a["logs"].iterdir())
    assert logs_a == sorted(p.name for p in b["logs"].iterdir())
    assert logs_a
    for name in logs_a:
        assert ((a["logs"] / name).read_bytes()
                == (b["logs"] / name).read_bytes()), name


@pytest.mark.parametrize("options", list(OPTION_SETS))
@pytest.mark.parametrize("source,n_windows,n_chunks", [
    ("tiles", N_TILE_WINDOWS, 8), ("paf", N_PAF_WINDOWS, 8)])
def test_dealt_scan_matches_one_device_and_jax(
        request, monkeypatch, tmp_path, options, source, n_windows,
        n_chunks):
    argv = request.getfixturevalue(f"{source}_source")()
    extra = OPTION_SETS[options]
    one = run_scan(argv, tmp_path / "one", extra)
    with monkeypatch.context() as mp:
        spy = DealSpy(mp, N_ENTRIES)
        dealt = run_scan(argv, tmp_path / "dealt", extra)
    spy.check(n_chunks)
    if source == "tiles":
        # every seed_risk window re-ran its FSTG on its batch's wire
        assert len(spy.exact) == len(RISK_WINDOWS)
    assert_same_outputs(one, dealt, "--afs" in extra)
    _, rows = read_table(dealt["tsv"])
    assert len(rows) == n_windows
    jax = run_scan(argv, tmp_path / "jax", extra, main=jax_main)
    assert_tables_close(jax["tsv"], dealt["tsv"])
    if "--afs" in extra:
        assert jax["afs"].read_bytes() == dealt["afs"].read_bytes()


@pytest.mark.parametrize("options", list(OPTION_SETS))
def test_dealt_journal_resumes_in_one_device_scan(tiles_source, monkeypatch,
                                                  tmp_path, options):
    """A dealt scan journals the first six windows; a one-device scan of
    all fifteen resumes from that journal: the journaled rows come back
    verbatim, and table, journal and spectrum equal those of a one-device
    scan resumed from a one-device journal of the same six windows."""
    extra = OPTION_SETS[options]
    with monkeypatch.context() as mp:
        spy = DealSpy(mp, N_ENTRIES)
        part_dealt = run_scan(tiles_source("w6.bed"), tmp_path / "part_d",
                              extra)
    spy.check(3)
    part_one = run_scan(tiles_source("w6.bed"), tmp_path / "part_1", extra)
    assert_same_outputs(part_one, part_dealt, "--afs" in extra)

    resumed = {}
    for tag, part in (("dealt", part_dealt), ("one", part_one)):
        out = tmp_path / f"full_{tag}"
        out.mkdir()
        journal = out / "scan.jsonl"
        journal.write_bytes(part["journal"].read_bytes())
        flags = [str(out / "scan.afs") if f == "AFS" else f for f in extra]
        assert torch_main(tiles_source() + flags + [
            "-o", str(out / "scan.tsv"), "--journal", str(journal),
            "--device", "cpu"]) == 0
        resumed[tag] = out
    _, rows_part = read_table(part_dealt["tsv"])
    _, rows_full = read_table(resumed["dealt"] / "scan.tsv")
    assert rows_full[:6] == rows_part
    assert len(rows_full) == N_TILE_WINDOWS
    names = ["scan.tsv", "scan.jsonl"] + (["scan.afs"] if "--afs" in extra
                                          else [])
    for name in names:
        assert ((resumed["dealt"] / name).read_bytes()
                == (resumed["one"] / name).read_bytes()), name
