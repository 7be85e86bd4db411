"""``cli.emit_batch``, the scan's drain of one batch, against the
per-window formulas it replaced (``oracle_emit`` below, one window, one
panel and one spectrum bin at a time): the table's text, the genome-wide
spectrum, the journal's lines and the window logs, byte for byte."""
from __future__ import annotations

import io
import json
import os
from typing import NamedTuple

import numpy as np
import pytest

from impop_tpu_torch import cli
from impop_tpu_torch.hostio import _write_window_log
from impop_tpu_torch.runtime.journal import ResultJournal
from impop_tpu_torch.scanstep import row_layout


class Region(NamedTuple):
    length: int


def oracle_emit(packed, kept, lay, panel_names, pair_list, out,
                journal_path, ehh_focal_pos, afs_total, log_dir,
                threshold):
    """The scan's emit as it was written before the batch emitter: each
    cell read as a NumPy scalar, the spectrum walked bin by bin, one
    journal line and one table line a window."""
    p_count = max(1, len(panel_names))
    for wi, (reg, rs) in enumerate(kept):
        row_v = packed[wi]
        n_v, s_v = int(row_v[lay["n"]]), int(row_v[lay["s"]])
        cells = [rs, str(reg.length), str(n_v), str(s_v)]
        for pi_idx in range(p_count):
            d_val = float(row_v[lay["d"] + pi_idx])
            cells += [f"{float(row_v[lay['pi'] + pi_idx]) / reg.length:.8f}",
                      "NA" if np.isnan(d_val) else f"{d_val:.6f}"]
        if panel_names:
            for qi in range(len(pair_list)):
                f3_val = float(row_v[lay["f3"] + qi])
                cells += [
                    f"{float(row_v[lay['fst'] + qi]):.8f}",
                    f"{float(row_v[lay['fstg'] + qi]):.8f}",
                    "NA" if np.isnan(f3_val) else f"{f3_val:.8f}",
                ]
        if ehh_focal_pos is not None:
            e = lay["ehh"]
            fp = ehh_focal_pos.get(rs)
            cells += ["NA" if fp is None else str(fp),
                      f"{float(row_v[e]):.6f}",
                      str(int(row_v[e + 2])),
                      f"{float(row_v[e + 1]):.6f}",
                      str(int(row_v[e + 3]))]
        row = "\t".join(cells)
        if log_dir:
            payload = {"region": rs, "length": reg.length,
                       "threshold": threshold, "n": n_v,
                       "segregating_sites": s_v}
            for pi_idx, pname in enumerate(panel_names or ["ALL"]):
                payload[f"pi_{pname}"] = (
                    float(row_v[lay["pi"] + pi_idx]) / reg.length)
                dv = float(row_v[lay["d"] + pi_idx])
                payload[f"tajd_{pname}"] = "NA" if np.isnan(dv) else dv
            for qi, (i, j) in enumerate(pair_list):
                tag = f"{panel_names[i]}_{panel_names[j]}"
                payload[f"fst_{tag}"] = float(row_v[lay["fst"] + qi])
                payload[f"fstg_{tag}"] = float(row_v[lay["fstg"] + qi])
                f3v = float(row_v[lay["f3"] + qi])
                payload[f"fst3_{tag}"] = "NA" if np.isnan(f3v) else f3v
            _write_window_log(log_dir, rs, "Fused Scan Window", payload)
        rec = {"row": row}
        if afs_total is not None:
            hist = row_v[lay["afs"]:].reshape(p_count, -1)
            sparse = {}
            for pi_idx in range(p_count):
                for k in np.nonzero(hist[pi_idx])[0]:
                    if k == 0:
                        continue
                    sparse[f"{pi_idx}:{int(k)}"] = int(hist[pi_idx, k])
                    afs_total[pi_idx, k] += int(hist[pi_idx, k])
            rec["afs"] = sparse
        with open(journal_path, "a") as fh:
            fh.write(json.dumps({"region": rs, **rec}) + "\n")
        print(row, file=out)


BINS = 9


def make_batch(panels: int, ehh: bool, afs: bool, seed: int = 11):
    """Six packed rows, four of them windows and two a short last
    chunk's padding full of junk.  Window 1 has a NaN D and a NaN FST3,
    window 2 no EHH focal and an all-zero spectrum; every spectrum but
    that one has a nonzero bin 0."""
    rng = np.random.default_rng(seed)
    names = ["AFR", "EUR", "EAS"][:panels]
    pairs = [(i, j) for i in range(panels) for j in range(i + 1, panels)]
    p_count = max(1, panels)
    lay = row_layout(p_count, len(pairs), ehh)
    width = lay["afs"] + (p_count * (BINS + 1) if afs else 0)
    packed = rng.normal(size=(6, width)).astype(np.float32)
    packed[:, lay["pi"]:lay["d"]] = rng.uniform(0, 40, (6, p_count))
    packed[:, lay["s"]] = rng.integers(0, 200, 6)
    packed[:, lay["n"]] = rng.integers(2, 466, 6)
    packed[1, lay["d"]] = np.nan
    if pairs:
        packed[1, lay["f3"] + len(pairs) - 1] = np.nan
    if ehh:
        packed[:, lay["ehh"]:lay["ehh"] + 2] = rng.uniform(0, 9, (6, 2))
        packed[:, lay["ehh"] + 2:lay["ehh"] + 4] = rng.integers(0, 300,
                                                                (6, 2))
    if afs:
        hist = rng.integers(0, 50, (6, p_count, BINS + 1))
        hist[rng.random(hist.shape) < 0.6] = 0
        hist[:, :, 0] = 7
        hist[2] = 0
        packed[:, lay["afs"]:] = hist.reshape(6, -1)
    packed[4:] = rng.uniform(-1e6, 1e6, packed[4:].shape)    # padding
    kept = [(Region(5000 + 7 * i),
             f"CHM13#0#chr1:{5000 * i}-{5000 * i + 5000}") for i in range(4)]
    focal = ({rs: 5000 * i + 2400 for i, (_, rs) in enumerate(kept) if i != 2}
             if ehh else None)
    return packed, kept, lay, names, pairs, focal


@pytest.mark.parametrize("panels", [3, 0], ids=["panels", "no_panels"])
@pytest.mark.parametrize("ehh", [True, False], ids=["ehh", "no_ehh"])
@pytest.mark.parametrize("afs", [True, False], ids=["afs", "no_afs"])
def test_emit_batch_matches_the_per_window_formulas(tmp_path, panels, ehh,
                                                    afs):
    packed, kept, lay, names, pairs, focal = make_batch(panels, ehh, afs)
    p_count = max(1, panels)
    start = np.arange(p_count * (BINS + 1), dtype=np.int64).reshape(
        p_count, BINS + 1)
    want_total = start.copy() if afs else None
    want_out = io.StringIO()
    oracle_emit(packed, kept, lay, names, pairs, want_out,
                tmp_path / "want.jsonl", focal, want_total,
                str(tmp_path / "want_logs"), 0.999)

    got_total = start.copy() if afs else None
    got_out = io.StringIO()
    journal = ResultJournal(str(tmp_path / "got.jsonl"))
    cli.emit_batch(packed.copy(), kept, lay, names, pairs, got_out, journal,
                   focal, got_total, str(tmp_path / "got_logs"), 0.999)
    assert got_out.getvalue() == want_out.getvalue()
    assert (tmp_path / "got.jsonl").read_bytes() == \
        (tmp_path / "want.jsonl").read_bytes()
    if afs:
        assert np.array_equal(got_total, want_total)
        assert got_total.dtype == np.int64
    logs = sorted(os.listdir(tmp_path / "want_logs"))
    assert len(logs) == 4 and sorted(os.listdir(tmp_path / "got_logs")) == logs
    for name in logs:
        assert (tmp_path / "got_logs" / name).read_bytes() == \
            (tmp_path / "want_logs" / name).read_bytes()
    text = got_out.getvalue()
    assert "\tNA" in text and "nan" not in text
    if afs:
        recs = [json.loads(ln) for ln in
                (tmp_path / "got.jsonl").read_text().splitlines()]
        assert recs[2]["afs"] == {} and all(r["afs"] for r in recs[:2])
        assert all(not k.endswith(":0") for r in recs for k in r["afs"])

    # a journal keeps no records in memory, and one without a file writes
    # nothing; the table is the same
    assert journal._records == {}
    bare = ResultJournal(None)
    bare_total = start.copy() if afs else None
    bare_out = io.StringIO()
    cli.emit_batch(packed, kept, lay, names, pairs, bare_out, bare, focal,
                   bare_total)
    assert bare_out.getvalue() == want_out.getvalue()
    assert bare._records == {} and all(bare.get(rs) is None
                                       for _, rs in kept)
    if afs:
        assert np.array_equal(bare_total, want_total)


def test_journal_record_many_appends_the_lines_record_writes(tmp_path):
    """One append of a batch writes the lines that one ``record`` a
    window writes, and a reopened journal reads every record back."""
    recs = [(f"chr1:{i}-{i + 1}", {"row": f"r{i}", "afs": {"0:1": i}})
            for i in range(3)]
    one, many = ResultJournal(str(tmp_path / "one")), \
        ResultJournal(str(tmp_path / "many"))
    for region, payload in recs:
        one.record(region, payload)
    many.record_many(recs)
    assert (tmp_path / "many").read_bytes() == (tmp_path / "one").read_bytes()
    again = ResultJournal(str(tmp_path / "many"))
    for region, payload in recs:
        assert again.get(region) == {"region": region, **payload}
