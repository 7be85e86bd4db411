"""Kill-mid-scan recovery on the port (the twin of
``tests/test_crash_resume.py``): a subprocess runs ``impop_tpu_torch.cli
scan --device cpu --batch 2 --drain-group 1`` and gets SIGKILL once the
journal holds two records; a torn tail line is appended; the resumed scan
reproduces the clean run's table byte for byte, and recomputes only what
the journal lacks (the journal grew)."""
from __future__ import annotations

import os
import signal
import subprocess
import sys
import time

import torch

from impop_tpu_torch.cli import main

torch.set_num_threads(1)

N_WINDOWS = 8


def write_inputs(tmp_path):
    from impop_tpu_torch.extract.simulate import simulate

    sim = simulate(str(tmp_path), ref_len=N_WINDOWS * 1000, n_haps=10,
                   seed=23, site_pool=60, span=(0, N_WINDOWS * 1000))
    bed = tmp_path / "w.bed"
    bed.write_text("".join(f"chr1\t{i * 1000}\t{(i + 1) * 1000}\n"
                           for i in range(N_WINDOWS)))
    (tmp_path / "agc.P1").write_text("HG00900\nHG00901\nHG00902\n")
    (tmp_path / "agc.P2").write_text("HG00903\nHG00904\n")
    return sim, bed


def scan_argv(tmp_path, sim, bed, out, journal):
    # one journal flush a batch of two windows, so that the kill lands
    # between flushes
    return ["scan", "-b", str(bed), "--paf", sim.paf_path,
            "--fasta", sim.fasta_path, "-P", "CHM13#0#",
            "--panel", str(tmp_path / "agc.P1"),
            "--panel", str(tmp_path / "agc.P2"),
            "--batch", "2", "--journal", str(journal), "-o", str(out),
            "--drain-group", "1", "--device", "cpu"]


def journal_lines(path):
    return [ln for ln in path.read_text().splitlines() if ln.strip()]


def test_sigkill_mid_scan_then_resume(tmp_path):
    sim, bed = write_inputs(tmp_path)
    out_clean = tmp_path / "clean.tsv"
    assert main(scan_argv(tmp_path, sim, bed, out_clean,
                          tmp_path / "clean.jsonl")) == 0

    journal = tmp_path / "crash.jsonl"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys; sys.path.insert(0, %r); import torch; "
            "torch.set_num_threads(1); "
            "from impop_tpu_torch.cli import main; main(%r)") % (
        root, scan_argv(tmp_path, sim, bed, tmp_path / "crash.tsv",
                        journal))
    proc = subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    killed = False
    deadline = time.time() + 120
    while time.time() < deadline and proc.poll() is None:
        if journal.exists():
            lines = journal.read_text().splitlines()
            if len(lines) >= N_WINDOWS:
                break                   # every window journaled: too late
            if len(lines) >= 2:
                os.kill(proc.pid, signal.SIGKILL)
                killed = True
                break
        time.sleep(0.005)
    proc.wait(timeout=60)
    assert killed, "the scan ended before the kill window"
    with open(journal, "a") as fh:       # a torn tail write from the kill
        fh.write('{"region": "CHM13#0#chr1:tor')

    n_before = len(journal_lines(journal))
    out_resume = tmp_path / "resume.tsv"
    assert main(scan_argv(tmp_path, sim, bed, out_resume, journal)) == 0
    assert out_resume.read_bytes() == out_clean.read_bytes()
    n_after = len(journal_lines(journal))
    assert n_after >= N_WINDOWS and n_before < n_after
