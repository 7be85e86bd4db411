"""The comparison that decides ``correct`` fails what it has to: the
control (the reference at TF32 in the program's place) and runs whose
timed path is broken underneath (half of each batch's windows left out,
one answer altered where it is produced, a step that fails)."""
import json

import pytest

from benchmark import control
from benchmark.spec import load_spec
from benchmark.tests.tiny import run_tiny, tiny_root

CELLS = ["hprc5kb.paf-chrom", "hprc5kb-full.tiles-chrom", "hprc5kb.locus"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(str(tmp_path_factory.mktemp("tiny")))


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [3, 2 ** 31 + 5])
def test_control_fails_and_reference_passes(root, cell, seed):
    spec = load_spec(root)
    c = spec.cell(cell)
    command = spec.command(c.traffic["command"])
    limits = c.config["limits"]
    ctl = control.control_numbers(command, c.config, c.traffic, seed,
                                  n_queries=6)
    assert any(v > limits[k] for k, v in ctl.items()), ctl
    ref = control.control_numbers(command, c.config, c.traffic, seed,
                                  mantissa=None, n_queries=6)
    assert all(v <= limits[k] for k, v in ref.items()), ref


def _broken_step(monkeypatch, fault):
    import impop_tpu_torch.scanstep as scanstep

    original = scanstep.scan_step

    def step(flat, cap_n, cap_s, p_count, pair_key, *rest, **kw):
        out = original(flat, cap_n, cap_s, p_count, pair_key, *rest, **kw)
        lay = scanstep.row_layout(p_count, len(pair_key))
        out = out.clone()
        if fault == "raises":
            raise RuntimeError("planted fault")
        if fault == "half":
            out[out.shape[0] // 2:] = 0
        else:
            out[0, lay["fst"]] += 1e-3
        return out

    monkeypatch.setattr(scanstep, "scan_step", step)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["half", "altered", "raises"])
def test_broken_timed_path_is_not_correct(root, monkeypatch, cell, fault):
    assert run_tiny(root, cell)["correct"]
    _broken_step(monkeypatch, fault)
    if fault == "raises":       # the warm-up fails: no result at all
        with pytest.raises(RuntimeError, match="warm-up call failed"):
            run_tiny(root, cell)
        return
    res = run_tiny(root, cell)
    assert not res["correct"], res["checks"]
    json.dumps(res)
