"""The port never loads JAX and never imports the JAX package: importing
every module of impop_tpu_torch in a fresh interpreter, and running a tiny
``scan`` and ``tajd`` through ``python -m impop_tpu_torch.cli`` on the CPU,
must leave ``jax`` and every ``impop_tpu`` / ``impop_tpu.*`` module out of
``sys.modules`` (the machine with the card has no JAX at all); so must
``ehh`` (matrix and extraction mode), ``sfs`` and ``makewindows``, and the
two processes of a ``scan --distributed`` on the CPU.  Also: the device
helper never moves to the CPU by itself, and nothing builds a kernel at
import time.  (``python -m impop_tpu_torch.bench`` is checked the same way
in tests/test_torch_bench.py.)"""
from __future__ import annotations

import os
import socket
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = [
    "impop_tpu_torch", "impop_tpu_torch.cli", "impop_tpu_torch.device",
    "impop_tpu_torch.hostio", "impop_tpu_torch.hostcmds",
    "impop_tpu_torch.scanstep", "impop_tpu_torch.scanrun",
    "impop_tpu_torch.io", "impop_tpu_torch.io.bed", "impop_tpu_torch.io.bgzf",
    "impop_tpu_torch.io.panels", "impop_tpu_torch.io.simtsv",
    "impop_tpu_torch.extract", "impop_tpu_torch.extract.agc",
    "impop_tpu_torch.extract.gfa", "impop_tpu_torch.extract.pyfallback",
    "impop_tpu_torch.extract.simulate", "impop_tpu_torch.report",
    "impop_tpu_torch.report.tables", "impop_tpu_torch.report.plots",
    "impop_tpu_torch.bench",
    "impop_tpu_torch.bench.gram_breakdown", "impop_tpu_torch.bench.inputs",
    "impop_tpu_torch.bench.kernel_shapes",
    "impop_tpu_torch.bench.oracle", "impop_tpu_torch.bench.roofline",
    "impop_tpu_torch.bench.main", "impop_tpu_torch.bench.__main__",
    "impop_tpu_torch.bench.check_device_oracle",
    "impop_tpu_torch.bench.gpu_smoke", "impop_tpu_torch.bench.pairwise",
    "impop_tpu_torch.bench.panelstep", "impop_tpu_torch.bench.windowstat",
    "impop_tpu_torch.bench.extract", "impop_tpu_torch.bench.extract_smoke",
    "impop_tpu_torch.bench.degenerate", "impop_tpu_torch.bench.ci_extract",
    "impop_tpu_torch.ops._build", "impop_tpu_torch.ops.ehhdeath",
    "impop_tpu_torch.ops.idgroup", "impop_tpu_torch.ops.pairdiff",
    "impop_tpu_torch.ops.panelquad", "impop_tpu_torch.ops.seedpeel",
    "impop_tpu_torch.ops.windowstat", "impop_tpu_torch.parallel",
    "impop_tpu_torch.parallel.scan", "impop_tpu_torch.parallel.mesh",
    "impop_tpu_torch.parallel.distributed",
    "impop_tpu_torch.parallel.longwindow",
    "impop_tpu_torch.parallel.pairspace", "impop_tpu_torch.parallel.dryrun",
    "impop_tpu_torch.runtime.batcher",
    "impop_tpu_torch.runtime.journal", "impop_tpu_torch.runtime.profiling",
    "impop_tpu_torch.runtime.sitestream", "impop_tpu_torch.stats.allele",
    "impop_tpu_torch.stats.api", "impop_tpu_torch.stats.diversity",
    "impop_tpu_torch.stats.ehh", "impop_tpu_torch.stats.fst",
    "impop_tpu_torch.stats.grouping", "impop_tpu_torch.stats.panelstats",
    "impop_tpu_torch.stats.pi", "impop_tpu_torch.stats.tajima",
    "impop_tpu_torch.stats.types",
]


FORBIDDEN = ("bad = sorted(m for m in sys.modules if m in ('jax', 'impop_tpu',"
             " 'bench', 'oracle') or m.startswith(('jax.', 'impop_tpu.')))\n"
             "print('forbidden:', bad)\n"
             "sys.exit(1 if bad else 0)\n")


# the CLI as ``python -c``, then the check of sys.modules
RUN_CLI = ("import runpy, sys\n"
           "sys.argv = ['impop_tpu_torch.cli'] + sys.argv[1:]\n"
           "try:\n"
           "    runpy.run_module('impop_tpu_torch.cli', run_name='__main__')\n"
           "except SystemExit as e:\n"
           "    if e.code:\n"
           "        raise\n" + FORBIDDEN)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(argv, world=2, timeout=300):
    """``argv`` in ``world`` processes of one gloo group on this host;
    returns their stdout.  A process that does not end within
    ``timeout`` seconds fails the test."""
    port = free_port()
    procs = []
    for rank in range(world):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update(PYTHONPATH=REPO, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), RANK=str(rank),
                   WORLD_SIZE=str(world), LOCAL_RANK="0",
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RUN_CLI, *argv], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed scan timed out")
        assert p.returncode == 0, out + err
        assert "forbidden: []" in out, out
        outs.append(out)
    return outs


def _run_clean(code, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=240)


def test_port_imports_without_jax():
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in MODULES)
            + "import impop_tpu_torch.ops._build as b\n"
            + "assert b._lib is None, 'kernel library loaded at import'\n"
            + "assert 'matplotlib' not in sys.modules, 'matplotlib at import'\n"
            + FORBIDDEN)
    proc = _run_clean(code, REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cli_runs_without_jax(tmp_path):
    """``scan`` (native PAF + FASTA extraction), ``tajd`` and ``sfs``
    (allele tiles), ``ehh`` (a matrix, and PAF + FASTA at a focal) and
    ``makewindows``, each as ``python -m impop_tpu_torch.cli ...
    --device cpu``, with inputs made by the port's own simulator."""
    code = f"""import runpy, sys
import numpy as np
from impop_tpu_torch.hostio import simulate

tmp = {str(tmp_path)!r}
sim = simulate(tmp, ref_len=3000, n_haps=6, seed=5, site_pool=20,
               span=(0, 3000))
open(tmp + '/w.bed', 'w').write('chr1\\t0\\t1500\\nchr1\\t1500\\t3000\\n')
open(tmp + '/agc.A', 'w').write('HG00900\\nHG00901\\nHG00902\\n')
open(tmp + '/agc.B', 'w').write('HG00903\\nHG00904\\n')
rng = np.random.default_rng(0)
import os
os.makedirs(tmp + '/tiles')
for k in range(2):
    np.savez(tmp + f'/tiles/chr1:{{1500 * k}}-{{1500 * (k + 1)}}.npz',
             geno=rng.integers(-1, 2, (9, 40)).astype(np.int8),
             names=np.array([f'HG{{j:05d}}#1#c' for j in range(9)]))
np.savetxt(tmp + '/m.txt', rng.integers(0, 2, (8, 35)), fmt='%d')
runs = [
    ['scan', '-b', tmp + '/w.bed', '--paf', sim.paf_path, '--fasta',
     sim.fasta_path, '-P', 'CHM13#0#', '--panel', tmp + '/agc.A',
     '--panel', tmp + '/agc.B', '-o', tmp + '/scan.tsv', '--device', 'cpu'],
    ['tajd', '-b', tmp + '/w.bed', '-P', '', '--geno-dir', tmp + '/tiles',
     '-o', tmp + '/tajd.tsv', '--device', 'cpu'],
    ['sfs', '-b', tmp + '/w.bed', '-P', '', '--geno-dir', tmp + '/tiles',
     '-o', tmp + '/sfs.tsv', '--device', 'cpu'],
    ['ehh', '-i', tmp + '/m.txt', '-p', '3', '-w', '10', '-o',
     tmp + '/ehh.tsv', '--device', 'cpu'],
    ['ehh', '--paf', sim.paf_path, '--fasta', sim.fasta_path, '-b',
     tmp + '/w.bed', '-P', 'CHM13#0#', '--focal', '700', '--focal', '2200',
     '-o', tmp + '/ehhx.tsv', '--device', 'cpu'],
    ['makewindows', '--region', 'chr1:0:3000', '-w', '1000', '-o',
     tmp + '/mw.bed'],
]
for argv in runs:
    sys.argv = ['impop_tpu_torch.cli'] + argv
    try:
        runpy.run_module('impop_tpu_torch.cli', run_name='__main__')
    except SystemExit as e:
        assert not e.code, (argv[0], e.code)
for name in ('scan.tsv', 'tajd.tsv', 'mw.bed'):
    rows = open(tmp + '/' + name).read().splitlines()
    assert len(rows) == 3, (name, rows)
for name, least in (('sfs.tsv', 2), ('ehh.tsv', 6), ('ehhx.tsv', 2)):
    rows = open(tmp + '/' + name).read().splitlines()
    assert len(rows) >= least, (name, rows)
""" + FORBIDDEN
    proc = _run_clean(code, str(tmp_path))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "forbidden: []" in proc.stdout


def test_resolve_device_never_falls_back():
    from impop_tpu_torch.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_distributed_scan_runs_without_jax(tmp_path):
    """``scan --distributed --device cpu`` in two processes of one gloo
    group, on windows made by the port's simulator: each process writes
    its part and loads neither ``jax`` nor ``impop_tpu``."""
    from impop_tpu_torch.hostio import simulate

    sim = simulate(str(tmp_path), ref_len=3000, n_haps=6, seed=5,
                   site_pool=20, span=(0, 3000))
    bed = tmp_path / "w.bed"
    bed.write_text("chr1\t0\t1000\nchr1\t1000\t2000\nchr1\t2000\t3000\n")
    out = tmp_path / "scan.tsv"
    run_ranks(["scan", "-b", str(bed), "--paf", sim.paf_path, "--fasta",
               sim.fasta_path, "-P", "CHM13#0#", "-o", str(out),
               "--device", "cpu", "--distributed"])
    rows = [len((tmp_path / f"scan.tsv.part{k}").read_text().splitlines())
            for k in range(2)]
    assert rows == [3, 2]                 # a header and 2 + 1 windows
