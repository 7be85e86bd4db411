"""The native scan path's metadata a batch at a time
(``scanrun.build_native``): the row sets of ``NativeBatch.row_sets`` and
the EHH focals of ``NativeBatch.nearest_sites``, held against the
per-window loop they replace, kept here as :func:`reference_build`.

The chunk holds two row sets and more (assemblies that cover part of the
reference, a duplicated query, a query whose row sorts on either side of
the reference row), a failed window, windows without sites, four target
groups over three targets (chr1 twice), and ``--ehh-focal`` targets inside
and outside windows, two in one window, and one equally near two sites.
A third target, chr3, holds two windows whose names differ in one name.
"""
from __future__ import annotations

import json
from typing import Tuple

import numpy as np
import pytest
import torch
from test_torch_build_masks import per_window_masks
from torch_helpers import partial_pangenome

from impop_tpu_torch import cli, scanrun
from impop_tpu_torch.extract import NativeExtractor
from impop_tpu_torch.hostio import _scan_buf_layout
from impop_tpu_torch.io.bed import Region
from impop_tpu_torch.io.panels import read_panel_file
from impop_tpu_torch.runtime.profiling import StageTimers

torch.set_num_threads(1)
PREFIX = "CHM13#0#"
PANELS = {"P1": "CHM13\nHG00900\nHG00901\nHG00902\n",
          "P2": "HG00903\nHG00904\nHG00909\n",
          "P3": "HG00902\nHG00905\nACHM13\n"}
# a query whose rows sort after the reference row of 3000-3500 and
# 3500-4000 and before that of 4000-4500: the same names, in another order
ORDER_QUERY = "CHM13#0#chr1:35"
CHUNK = ([("chr1", s, s + 500) for s in (0, 500, 1000, 2500, 3000, 3500,
                                         4000, 5500)]
         + [("chrX", 0, 500)]                    # no such target: no sites
         + [("chr1", 700, 700), ("chr1", 3000, 3500), ("chr1", 1000, 1500)]
         + [("chr2", s, s + 500) for s in (0, 500, 1500, 2500)])
# (panels, options) of build_native's parity cases
CASES = {
    "events": (("P1", "P2"), []),
    "columns-overlapping": (("P1", "P2", "P3"), ["--identity-mode",
                                                 "columns"]),
    "ehh-midpoint": (("P1", "P2", "P3"), ["--ehh"]),
    "ehh-focal-columns": (("P1", "P2"), ["--ehh", "--ehh-focal", "FOCAL",
                                         "--identity-mode", "columns"]),
    "no-panels-ehh-focal": ((), ["--ehh", "--ehh-focal", "FOCAL"]),
}


def _append_query(sim, name: str, seq: str, ts: int, target=None,
                  target_len=None) -> None:
    """``name`` aligned without a difference at ``ts`` of ``target`` (the
    reference's first sequence unless given)."""
    n = len(seq)
    target = target or sim.ref_name
    target_len = target_len or len(sim.ref_seq)
    with open(sim.fasta_path, "a") as fa, open(sim.paf_path, "a") as paf:
        fa.write(f">{name}\n" + "".join(seq[i:i + 60] + "\n"
                                        for i in range(0, n, 60)))
        paf.write(f"{name}\t{n}\t0\t{n}\t+\t{target}\t{target_len}\t"
                  f"{ts}\t{ts + n}\t{n}\t{n}\t60\tcg:Z:{n}=\n")


def _nearest_tie(ext) -> Tuple[int, int, str]:
    """A position equally near two adjacent sites of a CHUNK window, the
    first of the two, and the window's region string."""
    for chrom, start, end in CHUNK:
        if start < end:
            wm = ext.extract(PREFIX + chrom, start, end)
            pos = np.unique(np.asarray(wm.site_pos))
            for p, q in zip(pos[:-1].tolist(), pos[1:].tolist()):
                if (q - p) % 2 == 0:
                    return (p + q) // 2, p, f"{PREFIX}{chrom}:{start}-{end}"
    raise AssertionError("no two sites an even distance apart")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    from impop_tpu_torch.extract.simulate import simulate

    tmp = tmp_path_factory.mktemp("build_native")
    sim = partial_pangenome(str(tmp / "pan"))
    _append_query(sim, ORDER_QUERY, sim.ref_seq[3000:5000], 3000)
    # chr2: its assemblies cover 0-1500 only, so 1500-3000 has no sites
    two = simulate(str(tmp / "chr2"), ref_len=3000, n_haps=6, seed=11,
                   site_pool=15, span=(0, 1500), ref_name=PREFIX + "chr2")
    for mine, theirs in ((sim.fasta_path, two.fasta_path),
                         (sim.paf_path, two.paf_path)):
        with open(theirs) as fh:
            text = fh.read().replace("#ctg", "#ctgB")
        with open(mine, "a") as fh:
            fh.write(text)
    # chr3: windows 100-400 and 500-800 hold names of one length that
    # differ in the last one alone (a query on each, one over both)
    chr3 = "".join(np.random.default_rng(4).choice(list("ACGT"), 1000))
    with open(sim.fasta_path, "a") as fa:
        fa.write(f">{PREFIX}chr3\n" + "".join(
            chr3[i:i + 60] + "\n" for i in range(0, len(chr3), 60)))
    for name, ts, te in (("ZZ00001#1#chr3", 0, 400),
                         ("ZZ00002#1#chr3", 500, 900),
                         ("AA00001#1#chr3", 0, 1000)):
        _append_query(sim, name, chr3[ts:te], ts, PREFIX + "chr3", len(chr3))
    for name, text in PANELS.items():
        (tmp / f"agc.{name}").write_text(text)
    ext = NativeExtractor(sim.paf_path, sim.fasta_path)
    tie = _nearest_tie(ext)
    # file order, not position order, picks among the targets of a window
    (tmp / "focal.txt").write_text(
        f"# chrom pos\nchr1 {tie[0]}\nchr1 4700\nchr1 3400\nchr1 3100\n"
        "chr1 1000\nchr2 1700\nchr2 200\nchr9 50\n")
    return tmp, sim, ext, tie


def plan_of(tmp, panels, options):
    argv = ["scan", "-b", str(tmp / "unused.bed"), "-P", PREFIX]
    for p in panels:
        argv += ["--panel", str(tmp / f"agc.{p}")]
    argv += [str(tmp / "focal.txt") if o == "FOCAL" else o for o in options]
    return cli.build_parser().parse_args(argv)


def chunk_windows():
    regs = [Region(chrom, start, end) for chrom, start, end in CHUNK]
    return [(reg, reg.region_string(PREFIX)) for reg in regs]


def reference_build(plan, targets, extracted, pad_to):
    """``build_native`` as one loop over the windows: each window's names
    and sites read alone, its masks from its names' stems, its focal by
    ``np.argmin``.  Returns (wire, kept, failures, disjoint, caps, focal
    positions) and closes the batches."""
    groups, batches = extracted
    failures, kept, rows = [], [], []
    for gi, ((_tgt, items), nb) in enumerate(zip(groups, batches)):
        for k, (reg, rs) in enumerate(items):
            if nb.errors[k]:
                failures.append((rs, nb.errors[k]))
            else:
                kept.append((reg, rs))
                rows.append((gi, k))
    cap_n, cap_s = scanrun.ShapeFloors().caps(
        max(n for nb in batches for n, _ in nb.dims),
        max(s for nb in batches for _, s in nb.dims))
    w = pad_to or len(kept)
    lay = _scan_buf_layout(cap_n, cap_s, plan.p_count, plan.use_weights,
                           plan.want_ehh)
    flat = np.zeros((w, lay["total"]), np.uint8)
    row_of = {key: wi for wi, key in enumerate(rows)}
    for gi, nb in enumerate(batches):
        nb.pack_into(flat, [row_of.get((gi, k), -1) for k in range(nb.count)],
                     cap_n, cap_s, lay["m"], lay["sm"],
                     lay["w"] if plan.use_weights else -1)
    panels = np.zeros((w, plan.p_count, cap_n), bool)
    lengths = np.zeros(w, "<u4")
    focals = np.zeros(w, "<u4")
    position = {}
    for wi, ((gi, k), (reg, rs)) in enumerate(zip(rows, kept)):
        nb = batches[gi]
        lengths[wi] = reg.length
        sites = nb.site_pos(k)
        if plan.want_ehh and len(sites):
            target = (reg.start + reg.end) // 2
            for pos in targets.get(reg.chrom, ()):
                if reg.start <= pos < reg.end:
                    target = pos
                    break
            focals[wi] = int(np.argmin(np.abs(sites - target)))
            position[rs] = int(sites[focals[wi]])
        names = nb.names_blob(k).decode().splitlines()
        if plan.panel_lists:
            m = per_window_masks(names, plan.panel_lists)
            panels[wi, :, :m.shape[1]] = m
        else:
            panels[wi, 0, :len(names)] = True
    for nb in batches:
        nb.close()
    flat[:, lay["p"]:lay["l"]] = np.packbits(
        panels, axis=-1, bitorder="little").reshape(w, -1)
    flat[:, lay["l"]:lay["l"] + 4] = lengths.view(np.uint8).reshape(w, 4)
    if plan.want_ehh:
        flat[:, lay["f"]:lay["f"] + 4] = focals.view(np.uint8).reshape(w, 4)
    disjoint = bool(plan.pair_list) and not (
        panels[:, plan.pair_a] & panels[:, plan.pair_b]).any()
    return flat, kept, failures, disjoint, (cap_n, cap_s), position


def row_set_keys(ext, chunk):
    """Each kept window's row set as the per-window loop keyed it: its
    target and its sorted names with its reference row blanked."""
    keys = []
    for reg, rs in chunk:
        try:
            wm = ext.extract(rs.rsplit(":", 1)[0], reg.start, reg.end)
        except RuntimeError:
            continue
        names = sorted(wm.names)
        if rs in names:
            names[names.index(rs)] = None
        keys.append((rs.rsplit(":", 1)[0], tuple(names)))
    return keys


@pytest.mark.parametrize("pad_to", [None, 24])
@pytest.mark.parametrize("case", sorted(CASES))
def test_build_native_matches_the_per_window_loop(inputs, case, pad_to):
    tmp, sim, ext, tie = inputs
    panels, options = CASES[case]
    plan = scanrun.ScanPlan.from_args(plan_of(tmp, panels, options))
    chunk = chunk_windows()
    focus = scanrun.EhhFocus(str(tmp / "focal.txt") if "FOCAL" in options
                             else None)
    timers = StageTimers()
    with timers.bound("build"):
        prep = scanrun.build_native(
            plan, scanrun.PanelMasks(plan.panel_lists), focus,
            scanrun.ShapeFloors(), scanrun.extract_native(ext, chunk, 0),
            pad_to, torch.device("cpu"), 0)
    want, kept, failures, disjoint, caps, position = reference_build(
        plan, focus.targets, scanrun.extract_native(ext, chunk, 0), pad_to)

    got = prep.wire.numpy()
    assert got.shape == want.shape and got.tobytes() == want.tobytes()
    assert prep.kept == kept and prep.failures == failures
    assert prep.caps == caps and prep.disjoint == disjoint
    assert focus.position == position
    # the chunk exercises what it says it does
    assert [rs for rs, _ in failures] == [f"{PREFIX}chr1:700-700"]
    assert disjoint == (panels == ("P1", "P2"))
    if plan.want_ehh:
        inside = [rs for _, rs in kept if rs not in position]
        assert f"{PREFIX}chr2:1500-2000" in inside       # no sites
        assert f"{PREFIX}chrX:0-500" in inside
    if "FOCAL" in options:
        target, first, rs = tie
        assert position[rs] == first
        # two targets inside: the first in the file, not the least
        assert focus.targets_of([Region("chr1", 3000, 3500)]).tolist() \
            == [target if 3000 <= target < 3500 else 3400]

    counters = timers.to_json()["counters"]
    if not plan.panel_lists:
        assert "build.row_sets" not in counters
        return
    keys = row_set_keys(ext, chunk)
    assert counters["build.row_sets"] == len(set(keys))
    assert counters["masks.resolved_windows"] == len(set(keys))
    assert counters["masks.cached_windows"] == len(keys) - len(set(keys))
    assert 3 < len(set(keys)) < len(keys)


def test_row_sets_compare_whole_name_lists(inputs):
    """One name more, only the reference row, or the reference row at
    another place among the same names: a new set, the same set, a new
    set.  A failed window has none."""
    tmp, sim, ext, _ = inputs
    wins = [(5000, 5500), (5500, 6000), (3000, 3500), (3500, 4000),
            (4000, 4500), (3000, 3500), (700, 700)]
    regions = [f"{PREFIX}chr1:{s}-{e}" for s, e in wins]
    nb = ext.extract_batch_open(PREFIX + "chr1", wins)
    try:
        set_of, first = nb.row_sets(regions)
        names = [nb.names_blob(k).decode().splitlines() for k in range(6)]
        keys = [scanrun.PanelMasks.row_set_key(PREFIX + "chr1",
                                               nb.names_blob(k), regions[k])
                for k in range(6)]
        with pytest.raises(ValueError):
            nb.row_sets(regions[:-1])
    finally:
        nb.close()
    assert set_of.tolist() == [0, 1, 2, 2, 3, 2, -1]
    assert first.tolist() == [0, 1, 2, 4]
    # the names the three cases rest on
    missing = set(names[0][1:]) - set(names[1][1:])
    assert len(missing) == 1 and len(names[0]) == len(names[1]) + 1
    assert names[2][1:] == names[3][1:] and names[2][0] != names[3][0]
    assert names[2][:2] == [regions[2], ORDER_QUERY + ":0-2000"]
    assert names[4][:2] == [ORDER_QUERY + ":0-2000", regions[4]]
    assert names[2][2:] == names[4][2:]
    for i in range(6):
        for j in range(6):
            assert (set_of[i] == set_of[j]) == (keys[i] == keys[j])


def test_row_sets_compare_every_name(inputs):
    """Equally long name blobs that differ in their last name alone: two
    sets; the same window twice: one."""
    tmp, sim, ext, _ = inputs
    wins = [(100, 400), (500, 800), (100, 400)]
    regions = [f"{PREFIX}chr3:{s}-{e}" for s, e in wins]
    nb = ext.extract_batch_open(PREFIX + "chr3", wins)
    try:
        set_of, first = nb.row_sets(regions)
        blobs = [nb.names_blob(k) for k in range(3)]
    finally:
        nb.close()
    assert set_of.tolist() == [0, 1, 0] and first.tolist() == [0, 1]
    lines = [b.decode().splitlines() for b in blobs[:2]]
    assert [len(b) for b in blobs[:2]] == [len(blobs[0])] * 2
    assert lines[0][:2] == ["AA00001#1#chr3:0-1000", regions[0]]
    assert lines[1][:2] == ["AA00001#1#chr3:0-1000", regions[1]]
    assert lines[0][2:] == ["ZZ00001#1#chr3:0-400"]
    assert lines[1][2:] == ["ZZ00002#1#chr3:0-400"]


def test_nearest_sites_take_the_first_of_equally_near(inputs):
    tmp, sim, ext, tie = inputs
    wins = [(s, s + 500) for s in range(0, 6000, 500)] + [(700, 700)]
    rng = np.random.default_rng(3)
    nb = ext.extract_batch_open(PREFIX + "chr1", wins)
    try:
        sites = [nb.site_pos(k) if not nb.errors[k] else np.zeros(0, int)
                 for k in range(nb.count)]
        for targets in ([tie[0]] * nb.count,
                        [s for s, _ in wins], [e for _, e in wins],
                        rng.integers(-100, 7000, nb.count)):
            index, pos = nb.nearest_sites(np.asarray(targets))
            for k, (t, col) in enumerate(zip(targets, sites)):
                if len(col) == 0:
                    assert (index[k], pos[k]) == (-1, -1)
                else:
                    fi = int(np.argmin(np.abs(col - int(t))))
                    assert (index[k], pos[k]) == (fi, col[fi])
        assert nb.errors[-1] and sum(len(c) == 0 for c in sites) >= 2
        assert any(np.count_nonzero(np.abs(col - tie[0]) == np.abs(
            col - tie[0]).min()) >= 2 for col in sites if len(col))
    finally:
        nb.close()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_focal_targets_are_the_first_inside_in_file_order(tmp_path, seed):
    rng = np.random.default_rng(seed)
    lines = [f"chr{rng.integers(1, 3)} {rng.integers(0, 2000)}"
             for _ in range(60)]
    lines += ["chr1 0", "chr1 0", "chr1 1999"]
    (tmp_path / "focal.txt").write_text("\n".join(lines) + "\n")
    focus = scanrun.EhhFocus(str(tmp_path / "focal.txt"))
    regs = []
    for _ in range(80):
        start = int(rng.integers(-50, 2000))
        regs.append(Region(f"chr{rng.integers(1, 4)}", start,
                           start + int(rng.integers(1, 300))))
    want = []
    for reg in regs:
        target = (reg.start + reg.end) // 2
        for pos in focus.targets.get(reg.chrom, ()):
            if reg.start <= pos < reg.end:
                target = pos
                break
        want.append(target)
    assert focus.targets_of(regs).tolist() == want
    assert focus.targets_of([]).tolist() == []


def test_row_sets_counted_once_a_set_per_chunk(inputs):
    """``build.row_sets`` counts the chunk's sets, one a set whatever the
    batches that hold it: chr1's windows in two batches around chr2's."""
    tmp, sim, ext, _ = inputs
    args = plan_of(tmp, ("P1", "P2"), [])
    plan = scanrun.ScanPlan.from_args(args)
    masks = scanrun.PanelMasks(plan.panel_lists)
    regs = [Region("chr1", 3000, 3500), Region("chr1", 0, 500),
            Region("chr2", 0, 500), Region("chr1", 3500, 4000),
            Region("chr1", 500, 1000)]
    chunk = [(reg, reg.region_string(PREFIX)) for reg in regs]
    timers = StageTimers()
    found = []
    with timers.bound("build"):
        for _ in range(2):
            groups, batches = scanrun.extract_native(ext, chunk, 0)
            failures, kept, out_rows = scanrun._kept_rows(groups, batches)
            panels, set_panels = masks.panels_native(
                groups, batches, out_rows, len(kept), 64)
            found.append(len(set_panels))
            for nb in batches:
                nb.close()
    # 3000-3500 and 3500-4000 share a set; 0-500, 500-1000, chr2 one each
    counters = timers.to_json()["counters"]
    assert counters["build.row_sets"] == 2 * 4
    assert counters["masks.resolved_windows"] == 4
    assert counters["masks.cached_windows"] == 2 * 5 - 4
    assert found == [4, 4]
    for wi, (reg, rs) in enumerate(kept):
        names = ext.extract(rs.rsplit(":", 1)[0], reg.start, reg.end).names
        m = per_window_masks(sorted(names), [read_panel_file(
            tmp / f"agc.{p}") for p in ("P1", "P2")])
        assert np.array_equal(panels[wi, :, :m.shape[1]], m)
        assert not panels[wi, :, m.shape[1]:].any()


def test_scan_reports_row_sets(inputs):
    """``build.row_sets`` in ``--timing-json``: one set a batch here."""
    tmp, sim, ext, _ = inputs
    (tmp / "mid.bed").write_text("".join(f"chr1\t{s}\t{s + 500}\n"
                                         for s in (3000, 3500) * 3))
    timing = tmp / "timing.json"
    argv = ["scan", "-b", str(tmp / "mid.bed"), "--paf", sim.paf_path,
            "--fasta", sim.fasta_path, "-P", PREFIX, "--batch", "2",
            "--panel", str(tmp / "agc.P1"), "--panel", str(tmp / "agc.P2"),
            "-o", str(tmp / "mid.tsv"), "--device", "cpu",
            "--timing-json", str(timing)]
    assert cli.main(argv) == 0
    counters = json.loads(timing.read_text())["counters"]
    assert counters["build.row_sets"] == 3
    assert counters["masks.resolved_windows"] == 1
    assert counters["masks.cached_windows"] == 5
