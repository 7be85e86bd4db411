"""A copy of the benchmark's files at a size a CPU test holds: the same
cells, metrics and counts, with a 60 kb region, panels of a few
haplotypes, 8-window batches and one-second windows.  The copy also
holds the cells of ``later_cells.json``, whose files are in the
benchmark but whose entries are not in ``BENCHMARK.json`` yet (PERF.md,
section 7): the full option set from tiles and the locus queries."""
from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def tiny_root(dst: str) -> str:
    """Write the tiny copy under ``dst``; returns ``dst``."""
    bench = os.path.join(dst, "benchmark")
    for sub in ("metrics", "rooflines", "traffic", "configs", "commands"):
        shutil.copytree(os.path.join(HERE, sub), os.path.join(bench, sub))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        doc = json.load(fh)
    doc["run_seconds"] = 1
    with open(os.path.join(HERE, "tests", "later_cells.json")) as fh:
        later = json.load(fh)
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        doc[key] += later[key]
    for group in ("end_to_end", "per_layer"):
        for m in doc[group]:
            if m["name"] in later["shared"]:
                m["workloads"] += [w["name"] for w in later["workloads"]]
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as fh:
        json.dump(doc, fh)
    for c in doc["configs"]:
        path = os.path.join(dst, c["file"])
        with open(path) as fh:
            cfg = json.load(fh)
        cfg["data"]["region_bp"] = 60000
        cfg["data"]["panels"] = {"AFR": 14, "AMR": 8, "EAS": 10, "EUR": 6,
                                 "SAS": 8}
        cfg["scan"]["batch"] = 8
        cfg["judge"]["sample_windows"] = 4
        with open(path, "w") as fh:
            json.dump(cfg, fh)
    for name in os.listdir(os.path.join(bench, "traffic")):
        path = os.path.join(bench, "traffic", name)
        with open(path) as fh:
            mix = json.load(fh)
        if "warmup_windows" in mix:
            mix["warmup_windows"] = 8
        if "locus_bp" in mix:
            mix["locus_bp"] = [10000, 20000, 40000]
        with open(path, "w") as fh:
            json.dump(mix, fh)
    return dst


def run_tiny(root: str, workload: str, seed: int = 11, traced: bool = False,
             seconds: float = 1.0) -> dict:
    """One run of ``workload`` on the CPU (the plain versions of the
    kernels), as ``benchmark.run`` would make it on the card."""
    import time

    from benchmark.harness import run_cell
    from benchmark.spec import load_spec

    spec = load_spec(root)
    return run_cell(spec, spec.cell(workload), seed, seconds, traced,
                    time.perf_counter(), device="cpu")
