"""The native scan path's panel masks, computed once per row set
(``scanrun.build_native``), against the per-window computation they
replace: every wire buffer dealt to the device byte for byte, and the
``masks.*`` counters against the row sets the windows hold."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from torch_helpers import partial_pangenome

from impop_tpu_torch import cli, scanstep
from impop_tpu_torch.extract import NativeBatch, NativeExtractor
from impop_tpu_torch.hostio import _scan_buf_layout
from impop_tpu_torch.io.panels import expand_population, read_panel_file

torch.set_num_threads(1)

# P3 overlaps P1; P1 holds the reference's stem, P2 the duplicated
# query's, P3 the query whose rows' names hold the reference rows'
PANELS = {
    "P1": "CHM13\nHG00900\nHG00901\nHG00902\n",
    "P2": "HG00903\nHG00904\nHG00909\n",
    "P3": "HG00902\nHG00905\nACHM13\n",
}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    from impop_tpu_torch.extract.simulate import simulate

    tmp = tmp_path_factory.mktemp("build_masks")
    sims = {"partial": partial_pangenome(str(tmp / "partial")),
            "uniform": simulate(str(tmp / "uniform"), ref_len=6000,
                                n_haps=10, seed=5, site_pool=40,
                                span=(0, 6000))}
    (tmp / "w.bed").write_text("".join(f"chr1\t{s}\t{s + 500}\n"
                                       for s in range(0, 6000, 500)))
    for name, text in PANELS.items():
        (tmp / f"agc.{name}").write_text(text)
    return tmp, sims


def per_window_masks(names, panel_lists):
    """Window masks as the scan computed them per window before row sets:
    each name's stem (up to its first ``:``) against each panel."""
    if not panel_lists:
        return len(names)
    stems = [n.split(":", 1)[0] for n in names]
    masks = np.zeros((len(panel_lists), len(names)), bool)
    for pi, plist in enumerate(panel_lists):
        matched, _ = expand_population(plist, stems)
        masks[pi] = [s in matched for s in stems]
    return masks


@pytest.mark.parametrize("case,panels", [
    ("partial", ("P1", "P2", "P3")),
    ("uniform", ("P1", "P2", "P3")),
    ("partial", ()),
])
def test_wire_matches_per_window_masks(inputs, monkeypatch, case, panels):
    tmp, sims = inputs
    sim = sims[case]
    panel_lists = [read_panel_file(tmp / f"agc.{p}") for p in panels]
    p_count = max(1, len(panels))
    packed, dealt, row_sets = {}, [], set()
    pack_into = NativeBatch.pack_into
    open_batch = NativeExtractor.extract_batch_open
    deal_wire = scanstep.deal_wire

    def opened(self, target, windows, threads=0):
        nb = open_batch(self, target, windows, threads)
        nb.test_windows = [(target, int(s), int(e)) for s, e in windows]
        return nb

    def pack_and_keep(self, flat, out_rows, cap_n, cap_s, o_m, o_sm,
                      o_w=-1, threads=0):
        """Pack a second copy, and keep what the per-window path reads
        from the open batch: each kept window's masks and length."""
        own = np.zeros_like(flat)
        pack_into(self, own, out_rows, cap_n, cap_s, o_m, o_sm, o_w, threads)
        rows = []
        for k, row in enumerate(out_rows):
            if row < 0:
                continue
            tgt, ws, we = self.test_windows[k]
            names = self.names_blob(k).decode().splitlines()
            rs = f"{tgt}:{ws}-{we}"
            assert names.count(rs) == 1
            row_sets.add((tgt, tuple(n if n != rs else None for n in names))
                         if panel_lists else len(names))
            rows.append((row, per_window_masks(names, panel_lists), we - ws))
        packed.setdefault(id(flat), []).append((own, (cap_n, cap_s), rows))
        pack_into(self, flat, out_rows, cap_n, cap_s, o_m, o_sm, o_w, threads)

    def deal(flat, device):
        dealt.append((flat.copy(), packed.pop(id(flat))))
        return deal_wire(flat, device)

    monkeypatch.setattr(NativeExtractor, "extract_batch_open", opened)
    monkeypatch.setattr(NativeBatch, "pack_into", pack_and_keep)
    monkeypatch.setattr(scanstep, "deal_wire", deal)
    timing = tmp / f"timing-{case}-{len(panels)}.json"
    argv = ["scan", "-b", str(tmp / "w.bed"), "--paf", sim.paf_path,
            "--fasta", sim.fasta_path, "-P", "CHM13#0#", "--batch", "5",
            "-o", str(tmp / "out.tsv"), "--device", "cpu",
            "--timing-json", str(timing)]
    for p in panels:
        argv += ["--panel", str(tmp / f"agc.{p}")]
    assert cli.main(argv) == 0

    assert len(dealt) == 3 and not packed
    for flat, parts in dealt:
        (caps,) = {caps for _, caps, _ in parts}
        lay = _scan_buf_layout(*caps, p_count, False)
        assert lay["total"] == flat.shape[1]
        w, cap_n = flat.shape[0], caps[0]
        want = np.bitwise_or.reduce([own for own, _, _ in parts])
        masks = np.zeros((w, p_count, cap_n), bool)
        lengths = np.zeros(w, "<u4")
        for _, _, rows in parts:
            for row, m, length in rows:
                if panel_lists:
                    masks[row, :, :m.shape[1]] = m
                else:
                    masks[row, 0, :m] = True
                lengths[row] = length
        want[:, lay["p"]:lay["l"]] = np.packbits(
            masks, axis=-1, bitorder="little").reshape(w, -1)
        want[:, lay["l"]:lay["l"] + 4] = lengths.view(np.uint8).reshape(w, 4)
        assert want.tobytes() == flat.tobytes()

    counters = json.loads(timing.read_text())["counters"]
    if not panel_lists:
        # the row count is the mask: no names read, nothing cached
        assert not {"masks.cached_windows", "masks.resolved_windows"} \
            & set(counters)
        assert len(row_sets) == 4
        return
    assert counters["masks.cached_windows"] \
        + counters["masks.resolved_windows"] == 12
    assert counters["masks.resolved_windows"] == len(row_sets)
    # partial: both ends lose one assembly (one row set, in two batches);
    # the crafted query's two rows each hold their window's reference-row
    # name, so those two windows hold two row sets; the dup's two windows
    # one; the rest one.
    assert len(row_sets) == (1 if case == "uniform" else 5)
