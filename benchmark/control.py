"""The control of the comparison: the plain reference put in the program's
place, computed with every float value rounded to TF32 (10 mantissa
bits), the step below the float32 that the configurations state.  Its
rows, printed as the scan prints them, go through the same comparison as
a run's; each number has to come out above its limit.

    python3 -m benchmark.control --workload <name> --seeds 1,2,3

prints one JSON line a seed with the control's numbers (and, for
reference, those of the reference itself at float32, which read 0 but for
the printed digits).  Needs no GPU: the reference is NumPy.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import List, Optional

from benchmark import datagen, judge, loops
from benchmark.spec import load_spec

__all__ = ["control_numbers"]


def control_numbers(command, cfg: dict, mix: dict, seed: int,
                    mantissa: Optional[int] = 10, n_queries: int = 24
                    ) -> dict:
    """The comparison's numbers when rows computed by the reference at
    ``mantissa`` bits, written by ``command.reference_table``, stand in
    for one pass (or ``n_queries`` queries) of the cell's traffic on
    ``seed``'s data."""
    pg = datagen.make_pangenome(cfg, seed)
    truth = judge.WindowTruth(pg, cfg)
    stand_in = judge.WindowTruth(pg, cfg, mantissa=mantissa)
    queries = mix["loop"] == "queries"
    if queries:
        stream = loops.query_stream(cfg, mix, seed)
        asks = [next(stream) for _ in range(n_queries)]
    else:
        asks = [loops.pass_windows(cfg, mix)]
    with tempfile.TemporaryDirectory() as tmp:
        calls = [judge.Call(ws, os.path.join(tmp, f"{k}.tsv"), None)
                 for k, ws in enumerate(asks)]
        sample = judge.pick_sample(truth, calls,
                                   int(cfg["judge"]["sample_windows"]), seed,
                                   queries)
        for c in calls:
            command.reference_table(stand_in, c.windows, c.table,
                                    full=set(sample))
        numbers, _ = command.judge(truth, calls, sample,
                                 check_all_rows=not queries)
    return numbers


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    spec = load_spec()
    cell = spec.cell(args.workload)
    command = spec.command(cell.traffic["command"])
    for seed in (int(s) for s in args.seeds.split(",")):
        out = {"workload": args.workload, "seed": seed,
               "control_tf32": control_numbers(command, cell.config,
                                               cell.traffic, seed),
               "reference_f32": control_numbers(command, cell.config,
                                                cell.traffic, seed,
                                                mantissa=None),
               "limits": cell.config["limits"]}
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
