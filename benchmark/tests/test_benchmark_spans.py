"""The readers of the program's own spans and counters on a tiny CPU run
of ``hprc5kb.paf-chrom``: each reads a number (the step's device time
none on a CPU), and the spans nest as the program opens them; the step's
device time on a made-up trace."""
import pytest
import torch

from benchmark import harness
from benchmark.spec import load_spec
from benchmark.tests.tiny import run_tiny, tiny_root
from benchmark.trace import Trace

CELL = "hprc5kb.paf-chrom"
READERS = ["step_cpu_ms_per_batch.scan", "step_epilogue_ms_per_batch.scan",
           "step_device_ms_per_batch.scan", "build_cpu_ms_per_window.scan",
           "extract_native_ms_per_window.scan",
           "open_native_ms_per_call.scan", "extractors_open.scan"]


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """(spec, the run's view, its result line) of one traced tiny run."""
    root = tiny_root(str(tmp_path_factory.mktemp("tiny_spans")))
    views = []

    class Kept(harness.RunView):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            views.append(self)

    threads = torch.get_num_threads()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(harness, "RunView", Kept)
        # a window of several calls, so the handles left open a call have
        # calls to rise over: a tiny call takes about 0.2 s alone, and
        # seconds beside other test processes with a thread per core
        torch.set_num_threads(1)
        try:
            res = run_tiny(root, CELL, seed=2 ** 33 + 5, traced=True,
                           seconds=3.0)
        finally:
            torch.set_num_threads(threads)
    assert res["correct"] and len(views[0].calls) > 1, views[0].walls
    return load_spec(root), views[0], res


@pytest.mark.parametrize("name", READERS)
def test_reader_reads(traced, name):
    spec, view, res = traced
    got = spec.metric_reader(name).read(view)
    if name == "step_device_ms_per_batch.scan":
        assert got is None and name not in res["metrics"]
        return
    assert got is not None and got >= 0
    assert res["metrics"][name]["value"] == pytest.approx(float(got))


def _spans(call):
    f = {k: i for i, k in enumerate(call.timing["span_fields"])}
    return [{k: r[i] for k, i in f.items()} for r in call.timing["spans"]]


def test_step_parts_inside_device(traced):
    spec, view, _ = traced
    for call in view.calls:
        spans = _spans(call)
        by_id = {s["id"]: s for s in spans}
        dev = {s["batch"]: s for s in spans if s["name"] == "device"}
        assert dev
        parts = {}
        for s in spans:
            if s["name"] in ("step.stats", "step.epilogue"):
                assert by_id[s["parent"]]["name"] == "device"
                assert s["batch"] == by_id[s["parent"]]["batch"]
                parts[s["batch"]] = (parts.get(s["batch"], 0)
                                     + s["end_ns"] - s["start_ns"])
        for k, d in dev.items():
            assert parts[k] <= d["end_ns"] - d["start_ns"]
    cpu = spec.metric_reader("step_cpu_ms_per_batch.scan").read(view)
    assert cpu <= view.ms_per_stage_call("device")


def test_open_native_inside_setup_open(traced):
    spec, view, _ = traced
    got = spec.metric_reader("open_native_ms_per_call.scan").read(view)
    assert 0 < got <= view.ms_per_call("setup.open")
    leaked = spec.metric_reader("extractors_open.scan").read(view)
    assert leaked == 1.0                   # each call's handle stays open


def test_step_device_time_inside_device_marks(traced):
    """Busy time is counted once where kernels overlap, only inside the
    ``stage:device`` marks, and a mark duplicated by the harness's own
    wrapper counts as one batch."""
    spec, view, _ = traced

    def x(name, cat, ts, dur):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}

    events = [x("bench:window", "user_annotation", 0, 1000),
              x("stage:device", "user_annotation", 100, 100),
              x("stage:device", "user_annotation", 100, 99),   # nested twin
              x("stage:device", "user_annotation", 400, 100),
              x("k1", "kernel", 90, 30),       # 20 us inside the first
              x("k2", "kernel", 110, 20),      # overlaps k1: 10 us more
              x("k3", "kernel", 250, 50),      # between the marks
              x("k4", "kernel", 480, 60)]      # 20 us inside the second
    view.trace, kept = Trace(events), view.trace
    try:
        got = spec.metric_reader("step_device_ms_per_batch.scan").read(view)
    finally:
        view.trace = kept
    assert got == pytest.approx(1e-3 * (30 + 20) / 2)
