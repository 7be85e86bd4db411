"""The plain PyTorch reference (``benchmark/reference_torch.py``) against
the program and against the NumPy reference (``benchmark/reference.py``)
on the judged sample of a cell's windows.

    python3 -m benchmark.reference_gaps --workload <name> --seeds 1,2 \\
        [--device cuda] [--seconds S]

For each seed one timed run of the cell, as ``benchmark.run`` makes it
(``harness.run_cell``: the warm-up, then ``scan`` calls for ``S``
seconds, by default the benchmark's ``run_seconds``), whose calls'
tables and spectrum files the cell's comparison judges twice: against
the NumPy reference, as the run's own ``checks``, and against the
PyTorch reference on ``--device``, on the same sample (the densest
window and a seeded draw).  Prints one JSON line a seed:

- ``port_vs_torch``: the cell's comparison (``rows_wrong``, ``stat_gap``,
  ``tajd_gap``, ``ehh_gap``; the spectrum files whole) with the PyTorch
  reference in the NumPy reference's place, and the run's ``correct``,
  ``checks`` and end-to-end metrics;
- ``torch_vs_numpy``: the widest gap of each number between the two
  references over the sample, and the count of exact cells (S, groups,
  EHH focal and carriers, spectrum bins) that differ.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from benchmark import datagen, harness, judge, loops
from benchmark import reference_torch as rt
from benchmark.spec import load_spec

__all__ = ["TorchTruth", "sample_windows", "port_vs_torch",
           "timed_vs_torch", "torch_vs_numpy"]

Window = Tuple[int, int]


class TorchTruth(judge.WindowTruth):
    """The judge's view of the windows with each window's statistics and
    spectrum from the PyTorch reference on ``device``."""

    def __init__(self, pg: datagen.Pangenome, cfg: dict,
                 device: str = "cpu") -> None:
        super().__init__(pg, cfg)
        self.device = device
        self._rows: Dict[Window, dict] = {}

    def row(self, w: Window) -> dict:
        got = self._rows.get(w)
        if got is None:
            f = super().facts(w)
            got = rt.window_row(
                f["geno"], f["masks"], w[1] - w[0], self.pairs,
                self.cfg["scan"]["threshold"], self.weights(f["keys"]),
                pos=f["pos"] if self.ehh else None, mid=(w[0] + w[1]) // 2,
                afs_bins=self.bins if self.cfg["scan"].get("afs") else None,
                device=self.device)
            self._rows[w] = got
        return got

    def facts(self, w: Window) -> dict:
        """The generator's matrix and masks with the exact cells (S, n,
        the EHH focal and carriers) the PyTorch reference found."""
        r = self.row(w)
        got = dict(super().facts(w), n=r["n"], s=r["s"])
        if self.ehh:
            got.update(focal_pos=r["focal_pos"], carriers=r["carriers"])
        return got

    def stats(self, w: Window) -> dict:
        return self.row(w)

    def afs(self, w: Window) -> np.ndarray:
        return self.row(w)["afs"]


def sample_windows(truth: judge.WindowTruth, cfg: dict, mix: dict,
                   seed: int) -> List[Window]:
    """The windows a run's comparison would judge in full: one pass's
    distinct windows (a run's calls repeat them), sampled as
    :func:`judge.pick_sample` does."""
    call = judge.Call(loops.pass_windows(cfg, mix), "", None)
    return sorted(judge.pick_sample(truth, [call],
                                    int(cfg["judge"]["sample_windows"]),
                                    seed, False))


def port_vs_torch(command, cfg: dict, mix: dict, pg: datagen.Pangenome,
                  windows: List[Window], work: str,
                  device: str) -> Dict[str, float]:
    """The cell's comparison of one scan of ``windows`` (through the
    program on ``device``) against the PyTorch reference."""
    from impop_tpu_torch import cli

    inputs = harness._inputs(cfg, mix, pg, os.path.join(work, "data"))
    paths = loops.call_paths(work, 0)
    loops.write_bed(paths["bed"], cfg["chrom"], windows)
    argv = command.argv(cfg, mix, inputs, paths, device)
    if cli.main(argv):
        raise RuntimeError("scan failed")
    afs = paths["afs"] if paths["afs"] in argv else None
    truth = TorchTruth(pg, cfg, device)
    numbers, _ = command.judge(truth, [judge.Call(windows, paths["table"],
                                                  afs)], windows)
    return numbers


def timed_vs_torch(spec, workload: str, seed: int, seconds: float,
                   device: str) -> Tuple[dict, Dict[str, float],
                                         List[Window]]:
    """One timed run of ``workload`` (its result line) and the cell's
    comparison of the run's calls against the PyTorch reference on the
    sample the run judged, with that sample."""
    cell = spec.cell(workload)
    command = spec.command(cell.traffic["command"])
    numpy_judge, got = command.judge, {}

    def both(truth, calls, sample, **kw):
        got["torch"], _ = numpy_judge(TorchTruth(truth.pg, truth.cfg,
                                                 device), calls, sample, **kw)
        got["sample"] = list(sample)
        return numpy_judge(truth, calls, sample, **kw)

    command.judge = both
    spec.command = lambda name: command
    result = harness.run_cell(spec, cell, seed, seconds, False,
                              time.perf_counter(), device)
    return result, got["torch"], got["sample"]


def torch_vs_numpy(pg: datagen.Pangenome, cfg: dict, windows: List[Window],
                   device: str) -> Dict[str, float]:
    """The widest gap of each number between the two references over
    ``windows`` (relative for EHH areas) and the exact cells that
    differ."""
    ours, theirs = TorchTruth(pg, cfg, device), judge.WindowTruth(pg, cfg)
    gaps: Dict[str, float] = {"exact_cells_differ": 0.0}

    def gap(key, a, b, relative=False):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        if (np.isnan(a) != np.isnan(b)).any():
            gaps["exact_cells_differ"] += 1
        d = np.abs(np.nan_to_num(a) - np.nan_to_num(b))
        if relative:
            d = d / np.maximum(np.abs(np.nan_to_num(b)), 1e-30)
        gaps[key] = max(gaps.get(key, 0.0), float(d.max(initial=0.0)))

    for w in windows:
        a, b, f = ours.row(w), theirs.stats(w), theirs.facts(w)
        exact = [(a["s"], f["s"]), (a["n"], f["n"])]
        exact += list(zip(a["groups"], b["groups"]))
        exact += list(zip(a["union_groups"], b["union_groups"]))
        length = w[1] - w[0]
        gap("stat_gap", a["pi"] / length, b["pi"] / length)
        for key in ("fst", "fstg", "fst3"):
            gap("stat_gap", a[key], b[key])
        gap("tajd_gap", a["tajd"], b["tajd"])
        if ours.ehh:
            exact += [(a["focal_pos"], f["focal_pos"])]
            exact += list(zip(a["carriers"], f["carriers"]))
            gap("ehh_gap", a["ehh"][:2], b["ehh"][:2], relative=True)
        if "afs" in a:
            gaps["exact_cells_differ"] += float(
                (a["afs"][:, 1:] != theirs.afs(w)[:, 1:]).sum())
        gaps["exact_cells_differ"] += float(sum(int(u) != int(v)
                                                for u, v in exact))
    return gaps


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--seconds", type=float, default=None)
    args = p.parse_args(argv)
    spec = load_spec()
    cfg = spec.cell(args.workload).config
    seconds = (args.seconds if args.seconds is not None
               else float(spec.doc["run_seconds"]))
    for seed in (int(s) for s in args.seeds.split(",")):
        result, port, windows = timed_vs_torch(
            load_spec(spec.root), args.workload, seed, seconds, args.device)
        port = dict(port, correct=result["correct"],
                    attempted=result["attempted"],
                    checks={k: v["value"]
                            for k, v in result["checks"].items()},
                    metrics={k: v["value"]
                             for k, v in result["metrics"].items()})
        pg = datagen.make_pangenome(cfg, seed)
        out = {"workload": args.workload, "seed": seed,
               "device": args.device, "windows": len(windows),
               "port_vs_torch": port,
               "torch_vs_numpy": torch_vs_numpy(pg, cfg, windows,
                                                args.device),
               "limits": cfg["limits"]}
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
