"""The port's ``scan`` on the card at shapes the benchmark does not take.

    python -m impop_tpu_torch.bench.gpu_smoke [--device cuda|cpu]
        [--windows N] [--overlap-windows N]

1. cap 256 (200 haplotypes) with ``--ehh``, ``--windows`` windows of 5 kb
   in batches of 25: the window kernel and the EHH kernel at a shape
   other than the benchmark's; every row complete, π of the first panel
   a number.
2. overlapping panels (the non-disjoint layout: stripped-side rows in the
   grouping stack), 60 haplotypes, ``--overlap-windows`` windows, once on
   ``--device`` and once in a ``--device cpu`` process: every column
   within 2e-3, NA in the same places.

Exits non-zero on any failure.  The twin of the repository's
``tools/tpu_smoke.py``.
"""
from __future__ import annotations

import argparse
import math
import os
import shutil
import subprocess
import sys
import tempfile

WIN = 5000
TOL = 2e-3


def pangenome(tmp, n_haps, windows, site_pool, seed, panels):
    """(simulated pangenome, BED path, panel files): ``panels`` maps a
    panel name to a slice of the sorted sample names."""
    from impop_tpu_torch.extract.simulate import simulate

    ref_len = windows * WIN
    sim = simulate(tmp, ref_len=ref_len, n_haps=n_haps, site_pool=site_pool,
                   seed=seed, span=(0, ref_len))
    bed = os.path.join(tmp, "w.bed")
    with open(bed, "w") as fh:
        for lo in range(0, ref_len, WIN):
            fh.write(f"chr1\t{lo}\t{lo + WIN}\n")
    ents = sorted({h.name.split("#")[0] for h in sim.haplotypes})
    files = []
    for pname, sl in panels.items():
        path = os.path.join(tmp, f"agc.{pname}")
        with open(path, "w") as fh:
            fh.write("\n".join(ents[sl]) + "\n")
        files += ["--panel", path]
    return sim, bed, files


def scan_argv(sim, bed, panel_args, batch, out, device):
    return (["scan", "-b", bed, "--paf", sim.paf_path, "--fasta",
             sim.fasta_path, "-P", "CHM13#0#", *panel_args, "--batch",
             str(batch), "-o", out, "--device", device])


def part_ehh(device, tmp, windows) -> str:
    from impop_tpu_torch import cli

    sim, bed, panels = pangenome(
        tmp, 200, windows, 4000 * windows // 50, 31,
        {"PA": slice(0, 30), "PB": slice(30, 60), "PC": slice(60, 90)})
    out = os.path.join(tmp, "scan.tsv")
    if cli.main(scan_argv(sim, bed, panels, 25, out, device) + ["--ehh"]):
        raise RuntimeError("gpu_smoke 1: scan failed")
    with open(out) as fh:
        lines = fh.read().splitlines()
    if len(lines) != windows + 1:
        raise RuntimeError(f"gpu_smoke 1: {len(lines) - 1} rows, "
                           f"{windows} windows")
    hdr = lines[0].split("\t")
    for ln in lines[1:]:
        cells = ln.split("\t")
        if len(cells) != len(hdr):
            raise RuntimeError(f"gpu_smoke 1: short row {ln!r}")
        float(cells[hdr.index("EHH_AREA_REF")])
        int(cells[hdr.index("EHH_CARR_ALT")])
        if math.isnan(float(cells[4])):
            raise RuntimeError(f"gpu_smoke 1: {hdr[4]} is NaN in {ln!r}")
    return (f"gpu_smoke 1 OK on {device}: cap 256 + --ehh, {windows} "
            "windows")


def part_overlap(device, tmp, windows) -> str:
    from impop_tpu_torch import cli

    sim, bed, panels = pangenome(tmp, 60, windows, 1500 * windows // 20, 41,
                                 {"PA": slice(0, 20), "PB": slice(10, 30)})
    out_d = os.path.join(tmp, "scan_dev.tsv")
    if cli.main(scan_argv(sim, bed, panels, 20, out_d, device)):
        raise RuntimeError("gpu_smoke 2: scan failed")
    out_c = os.path.join(tmp, "scan_cpu.tsv")
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    proc = subprocess.run(
        [sys.executable, "-m", "impop_tpu_torch.cli",
         *scan_argv(sim, bed, panels, 20, out_c, "cpu")],
        env=env, cwd=root, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"gpu_smoke 2: the CPU scan failed:\n"
                           f"{proc.stderr[-2000:]}")
    with open(out_d) as fa, open(out_c) as fb:
        rows_d = [ln.split("\t") for ln in fa.read().splitlines()[1:]]
        rows_c = [ln.split("\t") for ln in fb.read().splitlines()[1:]]
    if len(rows_d) != windows or len(rows_c) != windows:
        raise RuntimeError(f"gpu_smoke 2: {len(rows_d)} / {len(rows_c)} "
                           f"rows, {windows} windows")
    worst = 0.0
    for ra, rb in zip(rows_d, rows_c):
        if ra[0] != rb[0]:
            raise RuntimeError(f"gpu_smoke 2: row {ra[0]} against {rb[0]}")
        for ca, cb in zip(ra[1:], rb[1:]):
            if ca == "NA" or cb == "NA":
                if ca != cb:
                    raise RuntimeError(f"gpu_smoke 2: {ra[0]} {ca} vs {cb}")
                continue
            d = abs(float(ca) - float(cb))
            worst = max(worst, d)
            if d > TOL:
                raise RuntimeError(f"gpu_smoke 2: {ra[0]} {ca} vs {cb}")
    return (f"gpu_smoke 2 OK: overlapping panels, {device} == cpu over "
            f"{windows} windows (max abs diff {worst:.2e})")


def main(argv=None) -> int:
    from impop_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser(prog="python -m impop_tpu_torch.bench."
                                 "gpu_smoke")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--windows", type=int, default=50)
    ap.add_argument("--overlap-windows", type=int, default=20)
    args = ap.parse_args(argv)
    resolve_device(args.device)
    tmp = tempfile.mkdtemp(prefix="gpu_smoke_")
    try:
        os.makedirs(os.path.join(tmp, "1"))
        os.makedirs(os.path.join(tmp, "2"))
        print(part_ehh(args.device, os.path.join(tmp, "1"), args.windows),
              flush=True)
        print(part_overlap(args.device, os.path.join(tmp, "2"),
                           args.overlap_windows), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
