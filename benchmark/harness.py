"""One run of one cell: inputs from the seed, set-up, the measured window
of ``scan`` calls, the check against the plain reference, the metrics.

The program under test is ``impop_tpu_torch``; every call goes through
``impop_tpu_torch.cli.main([<command>, ...])`` in this process, as a
user's command line would, with the arguments that the mix's command
(``benchmark/commands/<command>.py``) builds.  The program runs as it
ships: nothing here changes what it does (a traced run only marks its
stages in the trace).  Nothing here imports JAX or the JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import shutil
import time
from typing import Dict, List, Optional

from benchmark import datagen, judge, loops
from benchmark.peaks import card
from benchmark.spec import Cell, Spec
from benchmark.trace import Trace, annotate, profiled, read_trace

__all__ = ["CallRecord", "RunView", "run_cell", "WORK_DIR"]

WORK_DIR = os.path.join("benchmark", "_work")


@dataclasses.dataclass
class CallRecord:
    windows: List[tuple]
    wall: float                # seconds of the cli.main call
    rows: int                  # rows in its table
    timing: dict               # its --timing-json
    call: judge.Call


class RunView:
    """What a metric reader reads: the calls of the measured window, their
    stage timers, the set-up and window seconds, and, traced, the trace."""

    def __init__(self, spec: Spec, calls: List[CallRecord],
                 setup_s: float, window_s: float, trace: Optional[Trace],
                 truth: judge.WindowTruth, card: str) -> None:
        self.spec, self.calls = spec, calls
        self.setup_s, self.window_s = setup_s, window_s
        self.trace, self.truth, self.card = trace, truth, card

    def stage(self, *names: str) -> float:
        """Seconds summed over the calls' stages ``names``."""
        return sum(c.timing.get("stages", {}).get(n, {}).get("total_sec", 0.0)
                   for c in self.calls for n in names)

    def stage_calls(self, name: str) -> int:
        return sum(c.timing.get("stages", {}).get(name, {}).get("calls", 0)
                   for c in self.calls)

    def ms_per_window(self, *names: str) -> Optional[float]:
        """Milliseconds of the stages ``names`` per emitted window."""
        return 1e3 * self.stage(*names) / self.rows if self.rows else None

    def ms_per_call(self, *names: str) -> Optional[float]:
        """Milliseconds of the stages ``names`` per call of the window."""
        n = len(self.calls)
        return 1e3 * self.stage(*names) / n if n else None

    def ms_per_stage_call(self, name: str) -> Optional[float]:
        """Milliseconds of stage ``name`` per time it ran (per batch)."""
        n = self.stage_calls(name)
        return 1e3 * self.stage(name) / n if n else None

    @property
    def rows(self) -> int:
        """Windows whose rows the calls emitted."""
        return sum(c.rows for c in self.calls)

    @property
    def walls(self) -> List[float]:
        return [c.wall for c in self.calls]

    def windows(self):
        """Every window the completed calls scanned, repeats included."""
        for c in self.calls:
            if c.call.error is None:
                yield from c.windows


def _inputs(cfg: dict, mix: dict, pg: datagen.Pangenome, data: str) -> dict:
    os.makedirs(data, exist_ok=True)
    inputs = {"panels": datagen.write_panels(pg, data)}
    if mix["input"] == "paf":
        inputs["paf"], inputs["fasta"] = datagen.write_paf_fasta(pg, data)
    else:
        inputs["tiles"] = os.path.join(data, "tiles")
        datagen.write_tiles(pg, loops.tiled(cfg), inputs["tiles"])
    return inputs


def _call(cli, command, cfg, mix, inputs, work, k, windows, device,
          marks) -> CallRecord:
    paths = loops.call_paths(work, k)
    loops.write_bed(paths["bed"], cfg["chrom"], windows)
    argv = command.argv(cfg, mix, inputs, paths, device)
    error = None
    t0 = time.perf_counter()
    with annotate("bench:call", marks):
        try:
            rc = cli.main(argv)
            if rc:
                error = f"exit code {rc}"
        except Exception as e:  # a failed call is recorded and judged
            error = f"{type(e).__name__}: {e}"
    wall = time.perf_counter() - t0
    rows, times = 0, {}
    if error is None:
        with open(paths["table"]) as fh:
            rows = sum(1 for _ in fh) - 1
        if os.path.exists(paths["timing"]):
            with open(paths["timing"]) as fh:
                times = json.load(fh)
    afs = paths["afs"] if paths["afs"] in argv else None
    return CallRecord(windows, wall, rows, times,
                      judge.Call(windows, paths["table"], afs, error))


def _sync(device: str) -> None:
    if device.startswith("cuda"):
        import torch

        torch.cuda.synchronize()


def run_cell(spec: Spec, cell: Cell, seed: int, seconds: float,
             traced: bool, t_start: float, device: str = "cuda:0") -> dict:
    """The result line of one run (without its ``checks`` printed)."""
    cfg, mix = cell.config, cell.traffic
    command = spec.command(mix["command"])
    work_root = os.path.join(spec.root, WORK_DIR)
    shutil.rmtree(work_root, ignore_errors=True)
    work = os.path.join(work_root, f"{cfg['name']}-{seed}")
    import torch
    from impop_tpu_torch import cli

    with contextlib.ExitStack() as stack:
        stack.callback(shutil.rmtree, work_root, ignore_errors=True)
        pg = datagen.make_pangenome(cfg, seed)
        inputs = _inputs(cfg, mix, pg, os.path.join(work, "data"))
        # the inputs' pages reach the disk now, not during the window
        os.sync()

        if device.startswith("cuda"):
            from impop_tpu_torch.ops._build import load_library

            load_library()
        for i, windows in enumerate(loops.warmup_calls(cfg, mix)):
            rec = _call(cli, command, cfg, mix, inputs,
                        os.path.join(work, "warm"), i, windows, device, False)
            if rec.call.error is not None:
                raise RuntimeError(f"warm-up call failed: {rec.call.error}")
        _sync(device)
        setup_s = time.perf_counter() - t_start

        if mix["loop"] == "passes":
            plan = iter(lambda: loops.pass_windows(cfg, mix), None)
        else:
            plan = loops.query_stream(cfg, mix, seed)
        trace_path = os.path.join(work, "trace.json")
        calls: List[CallRecord] = []
        with (profiled(trace_path) if traced else contextlib.nullcontext()):
            with annotate("bench:window", traced):
                t0 = time.perf_counter()
                while not calls or time.perf_counter() - t0 < seconds:
                    calls.append(_call(cli, command, cfg, mix, inputs, work,
                                       len(calls), next(plan), device,
                                       traced))
                _sync(device)
                window_s = time.perf_counter() - t0
        trace = read_trace(trace_path) if traced else None
        on_gpu = device.startswith("cuda")
        peak = torch.cuda.max_memory_allocated() if on_gpu else 0
        kind = torch.cuda.get_device_name(0) if on_gpu else "cpu"
        gc.collect()
        if on_gpu:
            torch.cuda.empty_cache()

        truth = judge.WindowTruth(pg, cfg)
        queries = mix["loop"] == "queries"
        sample = judge.pick_sample(truth, [c.call for c in calls],
                                   int(cfg["judge"]["sample_windows"]), seed,
                                   queries)
        numbers, notes = command.judge(truth, [c.call for c in calls],
                                       sample, check_all_rows=not queries)
        limits = cfg["limits"]
        checks = {k: {"value": v, "limit": limits[k]}
                  for k, v in numbers.items()}
        failed_calls = [c for c in calls if c.call.error is not None]
        correct = (not failed_calls
                   and all(v <= limits[k] for k, v in numbers.items()))

        view = RunView(spec, calls, setup_s, window_s, trace, truth,
                       card() if (traced and on_gpu) else kind)
        metrics: Dict[str, dict] = {}
        for m in (cell.per_layer if traced else cell.end_to_end):
            got = spec.metric_reader(m["name"]).read(view)
            if got is None:
                continue
            entry = got if isinstance(got, dict) else {"value": float(got)}
            metrics[m["name"]] = dict(entry, unit=m["unit"])
        dev = {"platform": "gpu" if on_gpu else "cpu", "kind": kind,
               "count": 1, "memory_peak_bytes": int(peak)}
        result = {"correct": bool(correct),
                  "attempted": (len(calls) if queries
                                else sum(len(c.windows) for c in calls)),
                  "failed": (len(failed_calls) if queries else
                             sum(len(c.windows) for c in failed_calls)),
                  "metrics": metrics, "device": dev}
        if traced:
            dev["busy_s"] = trace.busy_s()
            dev["window_s"] = trace.window_s
            result["breakdown"] = {"device_ops": trace.device_ops(),
                                   "idle_gaps": trace.idle_gaps()}
        result["notes"] = notes
        result["checks"] = checks
        return result
