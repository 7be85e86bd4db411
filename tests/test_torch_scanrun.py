"""The scan's host parts (``impop_tpu_torch/scanrun.py``) called alone,
without ``cli.main``:

- ``PanelMasks``: a row set's masks (``for_row_set``) equal the masks of
  the window's names (``for_names``) and the per-window oracle of
  ``tests/test_torch_build_masks.py``, with the reference row blanked in
  the key; ``fill_row_sets`` counts ``masks.resolved_windows`` and
  ``masks.cached_windows``;
- ``build_native`` on CPU devices: the wire bytes of the per-window masks
  oracle, padding rows zero;
- ``InputPipeline``: chunk k built for device k mod D, in chunk order,
  with at most max(2, D) chunks in flight;
- the span inventory of a plain scan and of ``--identity-mode columns
  --ehh --afs``: (name, thread, parent name) from ``--timing-json``,
  which the benchmark's readers and the trace's ``stage:<name>`` labels
  depend on.
"""
from __future__ import annotations

import json
import threading

import numpy as np
import pytest
import torch
from test_torch_build_masks import per_window_masks
from torch_helpers import partial_pangenome

from impop_tpu_torch import cli, scanrun
from impop_tpu_torch.extract import NativeExtractor
from impop_tpu_torch.hostio import _scan_buf_layout, read_bed
from impop_tpu_torch.io.panels import read_panel_file
from impop_tpu_torch.runtime.profiling import StageTimers

torch.set_num_threads(1)
PREFIX = "CHM13#0#"
PANELS = {"P1": "CHM13\nHG00900\nHG00901\nHG00902\n",
          "P2": "HG00903\nHG00904\nHG00909\n",
          "P3": "HG00902\nHG00905\nACHM13\n"}

# (name, thread, parent name) of every span of the two scans below
PLAIN_SPANS = {
    ("setup", "main", None), ("setup.bed", "main", "setup"),
    ("setup.open", "main", "setup"), ("setup.panels", "main", "setup"),
    ("setup.journal", "main", "setup"),
    ("extract", "extract", None),
    ("build", "build", None), ("build.pack", "build", "build"),
    ("h2d", "build", None),
    ("wait_input", "main", None), ("device", "main", None),
    ("step.stats", "main", "device"), ("step.epilogue", "main", "device"),
    ("fetch", "main", None), ("emit", "main", None),
    # the assemblies that cover part of a window flag it seed_risk
    ("device.exact", "main", None),
}
OPTION_SPANS = {
    ("step.identity", "main", "step.stats"),
    ("step.groups", "main", "step.stats"),
    ("step.ehh", "main", "step.epilogue"),
    ("step.afs", "main", "step.epilogue"),
    ("emit.afs", "main", "emit"),
}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("scanrun")
    sim = partial_pangenome(str(tmp / "partial"))
    (tmp / "w.bed").write_text("".join(f"chr1\t{s}\t{s + 500}\n"
                                       for s in range(0, 6000, 500)))
    for name, text in PANELS.items():
        (tmp / f"agc.{name}").write_text(text)
    return tmp, sim


def scan_args(tmp, sim, *extra):
    argv = ["scan", "-b", str(tmp / "w.bed"), "--paf", sim.paf_path,
            "--fasta", sim.fasta_path, "-P", PREFIX, "--device", "cpu",
            *extra]
    for name in PANELS:
        argv += ["--panel", str(tmp / f"agc.{name}")]
    return cli.build_parser().parse_args(argv)


def windows(tmp, lo, hi):
    return [(reg, reg.region_string(PREFIX))
            for reg in read_bed(str(tmp / "w.bed"))[lo:hi]]


def test_row_set_masks_equal_the_names_masks(inputs):
    tmp, sim = inputs
    panel_lists = [read_panel_file(tmp / f"agc.{p}") for p in PANELS]
    masks = scanrun.PanelMasks(panel_lists)
    ext = NativeExtractor(sim.paf_path, sim.fasta_path)
    chunk = windows(tmp, 0, 12)
    nb = ext.extract_batch_open(PREFIX + "chr1",
                                [(reg.start, reg.end) for reg, _ in chunk])
    keys = []
    for k, (_, rs) in enumerate(chunk):
        blob = nb.names_blob(k)
        names = blob.decode().splitlines()
        key = masks.row_set_key(PREFIX + "chr1", blob, rs)
        assert rs.encode() not in key[1].split(b"\n")   # the row blanked
        keys.append(key)
        want = per_window_masks(names, panel_lists)
        assert np.array_equal(masks.for_row_set(key), want)
        assert np.array_equal(masks.for_names(tuple(names)), want)
    nb.close()

    fresh = scanrun.PanelMasks(panel_lists)
    timers = StageTimers()
    rows_by_key: dict = {}
    for wi, key in enumerate(keys):
        rows_by_key.setdefault(key, []).append(wi)
    n_cap = max(m.shape[1] for m in map(masks.for_row_set, keys))
    panels = np.zeros((len(keys), len(PANELS), n_cap), bool)
    with timers.bound("main"):
        fresh.fill_row_sets(panels, rows_by_key, len(keys))
        fresh.fill_row_sets(panels, rows_by_key, len(keys))
    for wi, key in enumerate(keys):
        m = masks.for_row_set(key)
        assert np.array_equal(panels[wi, :, :m.shape[1]], m)
        assert not panels[wi, :, m.shape[1]:].any()
    counters = timers.to_json()["counters"]
    # both ends lose an assembly, the crafted rows hold row sets of their
    # own: several row sets, each resolved once over both fills
    assert 1 < len(rows_by_key) < len(keys)
    assert counters["masks.resolved_windows"] == len(rows_by_key)
    assert counters["masks.cached_windows"] \
        == 2 * len(keys) - len(rows_by_key)


@pytest.mark.parametrize("pad_to", [None, 7])
def test_build_native_wire_matches_per_window_masks(inputs, pad_to):
    tmp, sim = inputs
    plan = scanrun.ScanPlan.from_args(scan_args(tmp, sim))
    ext = NativeExtractor(sim.paf_path, sim.fasta_path)
    chunk = windows(tmp, 3, 8)
    extracted = scanrun.extract_native(ext, chunk, 0)
    prep = scanrun.build_native(
        plan, scanrun.PanelMasks(plan.panel_lists), scanrun.EhhFocus(None),
        scanrun.ShapeFloors(), extracted, pad_to, torch.device("cpu"), 0)
    assert prep.kept == chunk and prep.failures == []
    got = prep.wire.numpy()

    cap_n, cap_s = prep.caps
    w = pad_to or len(chunk)
    lay = _scan_buf_layout(cap_n, cap_s, plan.p_count, False)
    want = np.zeros((w, lay["total"]), np.uint8)
    masks = np.zeros((w, plan.p_count, cap_n), bool)
    nb = ext.extract_batch_open(PREFIX + "chr1",
                                [(reg.start, reg.end) for reg, _ in chunk])
    nb.pack_into(want, list(range(len(chunk))), cap_n, cap_s, lay["m"],
                 lay["sm"])
    for k, (reg, _) in enumerate(chunk):
        m = per_window_masks(nb.names_blob(k).decode().splitlines(),
                             plan.panel_lists)
        masks[k, :, :m.shape[1]] = m
    nb.close()
    lengths = np.zeros(w, "<u4")
    lengths[:len(chunk)] = [reg.length for reg, _ in chunk]
    want[:, lay["p"]:lay["l"]] = np.packbits(
        masks, axis=-1, bitorder="little").reshape(w, -1)
    want[:, lay["l"]:lay["l"] + 4] = lengths.view(np.uint8).reshape(w, 4)
    assert got.shape == want.shape and got.tobytes() == want.tobytes()
    assert not got[len(chunk):].any()      # padding rows are inert


@pytest.mark.parametrize("n_devices", [1, 3])
def test_pipeline_deals_chunk_k_to_device_k_mod_d(n_devices):
    devs = [torch.device("cpu") for _ in range(n_devices)]
    chunks = [[("reg", f"w{k}")] for k in range(9)]
    lock, consumed, ahead = threading.Lock(), [0], []

    def extract(chunk, k):
        with lock:
            ahead.append(k - consumed[0])
        return chunk

    def build(extracted, pad_to, dev, k):
        return extracted, pad_to, dev, threading.current_thread().name

    timers = StageTimers()
    got, in_flight = [], []
    with timers.bound("main"), scanrun.InputPipeline(
            chunks, devs, 4, extract, build, timers) as pipe:
        depth = pipe.depth
        for k, built in pipe:
            got.append((k, built))
            in_flight.append(len(pipe.inflight))
            with lock:
                consumed[0] += 1
    assert depth == max(2, n_devices)
    assert [k for k, _ in got] == list(range(len(chunks)))
    for k, (extracted, pad_to, dev, thread) in got:
        assert extracted == chunks[k] and pad_to == 4
        assert dev is devs[k % n_devices]
    assert len({thread for *_, (*_, thread) in got}) == 1
    # after each hand-over the pipeline refills to its depth
    assert in_flight == [min(depth, len(chunks) - k - 1)
                         for k in range(len(chunks))]
    assert 0 < max(ahead) <= depth
    doc = timers.to_json()
    rows = [dict(zip(doc["span_fields"], r)) for r in doc["spans"]]
    assert sorted(r["batch"] for r in rows if r["name"] == "wait_input"
                  and r["thread"] == "main") == list(range(len(chunks)))


def test_one_chunk_is_not_padded():
    pipe = scanrun.InputPipeline([[("reg", "w0")]], [torch.device("cpu")],
                                 320, lambda c, k: c,
                                 lambda x, pad_to, dev, k: pad_to,
                                 StageTimers())
    with pipe:
        assert [built for _, built in pipe] == [None]


def test_span_inventory(inputs):
    """The spans' names, threads and parents of a plain scan and of the
    full option set, as the benchmark's readers find them."""
    tmp, sim = inputs
    timing = tmp / "timing.json"
    found = []
    for extra in ([], ["--identity-mode", "columns", "--ehh", "--afs",
                       str(tmp / "scan.afs")]):
        argv = ["scan", "-b", str(tmp / "w.bed"), "--paf", sim.paf_path,
                "--fasta", sim.fasta_path, "-P", PREFIX, "--batch", "5",
                "--panel", str(tmp / "agc.P1"), "--panel",
                str(tmp / "agc.P2"), "-o", str(tmp / "out.tsv"),
                "--device", "cpu", "--timing-json", str(timing), *extra]
        assert cli.main(argv) == 0
        doc = json.loads(timing.read_text())
        rows = [dict(zip(doc["span_fields"], r)) for r in doc["spans"]]
        names = {r["id"]: r["name"] for r in rows}
        found.append({(r["name"], r["thread"], names.get(r["parent"]))
                      for r in rows})
    assert found[0] == PLAIN_SPANS
    assert found[1] == PLAIN_SPANS | OPTION_SPANS
