"""The port's span recorder (``runtime/profiling.py``) and what ``scan``
records with it: spans on the pipeline's three threads with their batch,
parent and CPU time; the ``--timing-json`` schema; the counters of the
wire bytes, of the extractor's fallback windows and open handles; the
main thread's marks on a ``torch.profiler`` trace's clock; the workers'
spans in a ``--profile-dir`` trace."""
from __future__ import annotations

import json
import threading
import time

import pytest
import torch
from torch_helpers import partial_pangenome

from impop_tpu_torch import cli, scanrun
from impop_tpu_torch.runtime import profiling
from impop_tpu_torch.runtime.profiling import StageTimers, count, span

torch.set_num_threads(1)


def _rows(doc):
    f = doc["span_fields"]
    return [dict(zip(f, r)) for r in doc["spans"]]


def _busy(ms: float) -> None:
    """Spin until the calling thread has run ``ms`` on the CPU (not on the
    wall clock: a thread switched out for the other spinning thread, or
    for another process, would spin less CPU time than that)."""
    t_end = time.thread_time_ns() + ms * 1e6
    while time.thread_time_ns() < t_end:
        pass


def test_spans_on_three_threads_carry_parent_batch_and_cpu():
    timers = StageTimers()

    def worker(label, k):
        timers.bind(label)
        with span("outer", batch=k):
            with span("inner", cpu=True):
                _busy(2)
        count("work", 1)

    with timers.bound("main"):
        with span("device", batch=7, cpu=True):
            with span("step.stats", cpu=True):
                _busy(1)
            with span("step.epilogue", batch=8):
                pass
        threads = [threading.Thread(target=worker, args=(lab, k))
                   for k, lab in enumerate(("extract", "build"))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    doc = timers.to_json()
    rows = _rows(doc)
    by_id = {r["id"]: r for r in rows}
    assert len(rows) == 7
    assert {r["thread"] for r in rows} == {"main", "extract", "build"}
    for r in rows:
        if r["name"] in ("outer", "step.epilogue"):   # no CPU clock asked
            assert r["cpu_ns"] is None
        else:
            assert 0 <= r["cpu_ns"] <= r["end_ns"] - r["start_ns"]
        if r["name"] in ("device", "outer"):
            assert r["parent"] is None
        else:
            parent = by_id[r["parent"]]
            assert parent["thread"] == r["thread"]
            assert parent["start_ns"] <= r["start_ns"] <= r["end_ns"] \
                <= parent["end_ns"]
    names = {(r["thread"], r["name"]): r for r in rows}
    assert names[("main", "step.stats")]["batch"] == 7     # the parent's
    assert names[("main", "step.epilogue")]["batch"] == 8  # its own
    for k, lab in enumerate(("extract", "build")):
        assert names[(lab, "outer")]["batch"] == k
        assert names[(lab, "inner")]["batch"] == k
        assert names[(lab, "inner")]["parent"] == names[(lab, "outer")]["id"]
    assert names[("extract", "inner")]["cpu_ns"] > 1e6   # a busy 2 ms
    assert doc["counters"] == {"work": 2}
    assert doc["stages"]["outer"]["calls"] == 2
    assert set(doc["stages"]["outer"]) == {"total_sec", "calls"}
    assert doc["stages"]["device"]["total_sec"] == pytest.approx(
        (names[("main", "device")]["end_ns"]
         - names[("main", "device")]["start_ns"]) * 1e-9)


def test_span_and_count_without_a_recorder_do_nothing():
    timers = StageTimers()
    seen = {}

    def unbound():
        with span("x", batch=1):
            count("n", 3)
        seen["ok"] = True

    t = threading.Thread(target=unbound)
    t.start()
    t.join()
    assert seen["ok"]
    with timers.bound("main"):
        pass
    with span("after"):            # the binding ended with its block
        count("n")
    assert timers.spans == [] and timers.counters == {}


def test_recorder_loses_nothing_under_thread_switches():
    """More threads than cores, switching every microsecond: every span,
    stage count and counter increment is kept, every id once."""
    import os
    import sys

    timers = StageTimers()
    n_threads, per = 2 * (os.cpu_count() or 4) + 2, 300

    def worker(i):
        timers.bind(f"w{i}")
        for k in range(per):
            with span("s", batch=k):
                count("c")

    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(before)
    assert not any(t.is_alive() for t in threads)
    doc = timers.to_json()
    assert doc["stages"]["s"]["calls"] == n_threads * per
    assert doc["counters"]["c"] == n_threads * per
    assert len({r[0] for r in doc["spans"]}) == n_threads * per


def test_stage_is_a_span_of_one_name():
    """``StageTimers.stage(name)``, the form a caller outside the program
    may wrap, records as :func:`span` does on a bound thread."""
    timers = StageTimers()
    with timers.bound("main"):
        with timers.stage("x"):
            with span("y", batch=3):
                pass
    doc = timers.to_json()
    x, y = _rows(doc)
    assert x["thread"] == y["thread"] == "main"
    assert (x["batch"], y["batch"], y["parent"]) == (None, 3, x["id"])
    assert x["cpu_ns"] is None
    assert doc["stages"]["x"]["calls"] == 1
    assert getattr(profiling._bound, "rec", None) is None


@pytest.fixture(scope="module")
def scan_inputs(tmp_path_factory):
    from impop_tpu_torch.extract.simulate import simulate

    tmp = tmp_path_factory.mktemp("profiling_scan")
    sims = {"uniform": simulate(str(tmp), ref_len=6000, n_haps=10, seed=5,
                                site_pool=40, span=(0, 6000)),
            "partial": partial_pangenome(str(tmp / "partial"))}
    (tmp / "w500.bed").write_text("".join(f"chr1\t{s}\t{s + 500}\n"
                                          for s in range(0, 6000, 500)))
    (tmp / "sorted.bed").write_text("chr1\t0\t1500\nchr1\t1500\t3000\n"
                                    "chr1\t3000\t4500\nchr1\t4500\t6000\n")
    (tmp / "overlap.bed").write_text("chr1\t0\t1500\nchr1\t1000\t2500\n"
                                     "chr1\t2500\t4000\nchr1\t3500\t6000\n")
    (tmp / "agc.P1").write_text("HG00900\nHG00901\nHG00902\n")
    (tmp / "agc.P2").write_text("HG00903\nHG00904\n")

    def run(bed="sorted.bed", batch=2, extra=(), sim="uniform"):
        timing = tmp / "timing.json"
        argv = ["scan", "-b", str(tmp / bed), "--paf", sims[sim].paf_path,
                "--fasta", sims[sim].fasta_path, "-P", "CHM13#0#", "--batch",
                str(batch), "--panel", str(tmp / "agc.P1"), "--panel",
                str(tmp / "agc.P2"), "-o", str(tmp / "out.tsv"),
                "--device", "cpu", "--timing-json", str(timing), *extra]
        assert cli.main(argv) == 0
        return json.loads(timing.read_text())

    return tmp, run


def test_timing_json_schema_and_wire_bytes(scan_inputs, monkeypatch):
    from impop_tpu_torch import scanstep

    dealt = []
    deal = scanstep.deal_wire

    def counted(flat, device):
        dealt.append(flat.nbytes)
        return deal(flat, device)

    monkeypatch.setattr(scanstep, "deal_wire", counted)
    _, run = scan_inputs
    doc = run()
    assert doc["windows"] == 4
    for name in ("setup", "setup.open", "extract", "build", "build.pack",
                 "h2d", "wait_input", "device", "step.stats",
                 "step.epilogue", "fetch", "emit"):
        st = doc["stages"][name]
        assert set(st) == {"total_sec", "calls"} and st["total_sec"] >= 0
    assert doc["stages"]["device"]["calls"] == 2
    assert set(doc["clock"]) == {"perf_ns", "unix_ns"}
    rows = _rows(doc)
    assert len(rows) == sum(st["calls"] for st in doc["stages"].values())
    threads = {r["name"]: r["thread"] for r in rows}
    assert threads["extract"] == "extract" and threads["build"] == "build"
    assert threads["device"] == threads["setup"] == "main"
    for name in ("extract", "build", "h2d", "wait_input", "device", "fetch",
                 "emit", "step.stats", "step.epilogue", "build.pack"):
        assert sorted(r["batch"] for r in rows if r["name"] == name) == [0, 1]
    assert all(r["batch"] is None for r in rows
               if r["name"].startswith("setup"))
    for r in rows:     # the thread's CPU clock where a reader needs it
        if r["name"] in ("device", "build"):
            assert 0 <= r["cpu_ns"] <= r["end_ns"] - r["start_ns"]
        else:
            assert r["cpu_ns"] is None
    c = doc["counters"]
    assert len(dealt) == 2 and c["bytes.h2d"] == sum(dealt)
    assert c["extract.range_windows"] == 4
    assert c["extract.fallback_windows"] == 0
    assert c["extract.native_ns"] > 0 and c["open.native_ns"] > 0
    assert doc["stages"]["setup.open"]["total_sec"] * 1e9 \
        >= c["open.native_ns"]


@pytest.mark.parametrize("bed,fallback", [("sorted.bed", 0),
                                          ("overlap.bed", 4)])
def test_fallback_windows(scan_inputs, bed, fallback):
    _, run = scan_inputs
    c = run(bed=bed, batch=4)["counters"]
    assert c["extract.fallback_windows"] == fallback
    assert c["extract.range_windows"] == 4 - fallback
    assert c["extract.native_ns"] > 0


@pytest.mark.parametrize("sim,bed,row_sets", [
    ("uniform", "sorted.bed", 1),      # every assembly end to end
    ("partial", "w500.bed", None),     # assemblies over part of it
])
def test_mask_counters(scan_inputs, sim, bed, row_sets):
    """Every emitted window's masks are cached or resolved; the resolved
    windows are the row sets: one where every window holds every
    assembly, more where they do not (tests/test_torch_build_masks.py
    counts them)."""
    _, run = scan_inputs
    doc = run(bed=bed, batch=5, sim=sim)
    c = doc["counters"]
    assert c["masks.cached_windows"] + c["masks.resolved_windows"] \
        == doc["windows"] > 0
    if row_sets is None:
        assert c["masks.resolved_windows"] > 1
    else:
        assert c["masks.resolved_windows"] == row_sets


def test_extractors_open_gauge(scan_inputs):
    from impop_tpu_torch.extract import NativeExtractor

    tmp, run = scan_inputs
    first = run()["counters"]["extractors.open"]
    assert run()["counters"]["extractors.open"] == first + 1  # left open
    paf = next(tmp.glob("*.paf"))
    fasta = next(p for p in tmp.iterdir()
                 if p.suffix in (".fa", ".fasta"))
    with NativeExtractor(str(paf), str(fasta)) as a:
        n_a = a.stats()["extractors.open"]
        b = NativeExtractor(str(paf), str(fasta))
        assert b.stats()["extractors.open"] == n_a + 1
        b.close()
        assert a.stats()["extractors.open"] == n_a
        assert NativeExtractor.open_count == n_a
    assert NativeExtractor.open_count == n_a - 1


def test_setup_span_closes_on_error(scan_inputs):
    tmp, _ = scan_inputs
    args = cli.build_parser().parse_args(
        ["scan", "-b", str(tmp / "sorted.bed"), "--device", "cpu"])
    timers = StageTimers()
    with timers.bound("main"):
        with pytest.raises(SystemExit):
            scanrun.run(args, timers)     # no input: set-up fails
        with span("later"):
            pass
    rows = {r["name"]: r for r in _rows(timers.to_json())}
    assert rows["setup"]["end_ns"] > 0
    assert rows["later"]["parent"] is None


def test_profiler_marks_sit_on_their_spans(scan_inputs, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    _, run = scan_inputs
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        doc = run()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = trace["baseTimeNanoseconds"]
    shift = doc["clock"]["unix_ns"] - doc["clock"]["perf_ns"] - base
    marks = {}
    for e in trace["traceEvents"]:
        if e.get("ph") == "X" and e.get("name", "").startswith("stage:"):
            marks.setdefault(e["name"][6:], []).append(
                (float(e["ts"]) * 1e3, float(e["ts"] + e["dur"]) * 1e3))
    main = [r for r in _rows(doc) if r["thread"] == "main"]
    assert {"device", "step.stats", "step.epilogue", "wait_input",
            "fetch", "emit", "setup"} <= {r["name"] for r in main}
    for name in {r["name"] for r in main}:
        spans = sorted((r["start_ns"] + shift, r["end_ns"] + shift)
                       for r in main if r["name"] == name)
        got = sorted(marks[name])
        assert len(got) == len(spans), name
        for (a, b), (ma, mb) in zip(spans, got):
            assert abs(a - ma) <= 2e6 and abs(b - mb) <= 2e6, name


def test_profile_dir_trace_holds_worker_spans(scan_inputs, tmp_path):
    _, run = scan_inputs
    doc = run(extra=("--profile-dir", str(tmp_path)))
    trace = json.loads((tmp_path / "trace.json").read_text())
    names = {e["tid"]: e["args"]["name"] for e in trace["traceEvents"]
             if e.get("ph") == "M" and e.get("name") == "thread_name"
             and str(e["args"].get("name", "")).startswith("spans ")}
    assert set(names.values()) == {"spans main", "spans extract",
                                   "spans build"}
    spans = [e for e in trace["traceEvents"]
             if e.get("cat") == "program_span"]
    on = {(names[e["tid"]], e["name"]) for e in spans}
    assert {("spans extract", "extract"), ("spans build", "build"),
            ("spans main", "device")} <= on
    # every span of the pipeline ended inside the session
    pipeline = [r for r in _rows(doc) if not r["name"].startswith("setup")]
    assert len(spans) == len(pipeline)
    for e in spans:
        assert e["dur"] >= 0 and {"batch", "parent", "cpu_ns"} <= set(
            e["args"])
        assert (e["args"]["cpu_ns"] is not None) == (e["name"] in
                                                     ("device", "build"))


def test_scans_leave_no_recorder_bound(scan_inputs):
    _, run = scan_inputs
    run()
    assert getattr(profiling._bound, "rec", None) is None


OPTION_SPANS = {"step.identity": "step.stats", "step.groups": "step.stats",
                "step.ehh": "step.epilogue", "step.afs": "step.epilogue",
                "emit.afs": "emit"}


@pytest.mark.parametrize("options,due", [
    (("--identity-mode", "columns", "--ehh", "--afs"), set(OPTION_SPANS)),
    (("--identity-mode", "columns"), {"step.identity", "step.groups"}),
    (("--ehh",), {"step.ehh"}),
    ((), set()),                     # the events scan: none of them
])
def test_option_spans_sit_under_their_parents(scan_inputs, tmp_path,
                                              options, due):
    """The step's option branches and the spectrum's emit open their
    spans, one a batch under their parent (``emit.afs`` under its batch's
    ``emit``), only where they run; the counter ``afs.bins_emitted``
    counts the journal's spectrum bins and ``journal.writes`` one append
    a batch."""
    _, run = scan_inputs
    journal = tmp_path / "journal.jsonl"
    extra = [*options, "--journal", str(journal)]
    if "--afs" in options:
        extra.insert(extra.index("--afs") + 1, str(tmp_path / "afs.tsv"))
    doc = run(extra=extra)
    rows = _rows(doc)
    by_id = {r["id"]: r for r in rows}
    batches = sorted(r["batch"] for r in rows if r["name"] == "device")
    assert {r["name"] for r in rows} & set(OPTION_SPANS) == due
    entries = [json.loads(ln) for ln in journal.read_text().splitlines()]
    assert len(entries) == doc["windows"] == 4
    for name in due:
        got = [r for r in rows if r["name"] == name]
        assert sorted(r["batch"] for r in got) == batches, name
        for r in got:
            parent = by_id[r["parent"]]
            assert parent["name"] == OPTION_SPANS[name]
            assert parent["batch"] == r["batch"]
            assert parent["start_ns"] <= r["start_ns"] <= r["end_ns"] \
                <= parent["end_ns"]
    bins = sum(len(e.get("afs", {})) for e in entries)
    if "emit.afs" in due:
        assert doc["counters"]["afs.bins_emitted"] == bins > 0
    else:
        assert "afs.bins_emitted" not in doc["counters"] and bins == 0
    assert doc["counters"]["journal.writes"] == len(batches) == 2


def test_spectrum_bins_counted_without_a_journal(scan_inputs, tmp_path):
    """Without ``--journal`` the spectrum's emit still counts the nonzero
    bins, as many as a journaled scan writes, in one ``emit.afs`` a batch,
    and counts no journal append."""
    _, run = scan_inputs
    afs = ["--afs", str(tmp_path / "afs.tsv")]
    journal = tmp_path / "journal.jsonl"
    journaled = run(extra=[*afs, "--journal", str(journal)])
    bins = sum(len(json.loads(ln)["afs"])
               for ln in journal.read_text().splitlines())
    doc = run(extra=afs)
    assert doc["counters"]["afs.bins_emitted"] == bins > 0
    assert journaled["counters"]["afs.bins_emitted"] == bins
    assert doc["counters"].get("journal.writes", 0) == 0
    rows = _rows(doc)
    assert sorted(r["batch"] for r in rows if r["name"] == "emit.afs") \
        == sorted(r["batch"] for r in rows if r["name"] == "emit") == [0, 1]
