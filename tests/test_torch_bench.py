"""impop_tpu_torch.bench (the twin of bench.py) against bench.py and the
JAX package on the CPU, on the same seeded windows.

Tolerances: π / length, D and EHH areas rtol 1e-5 (float32 sums in another
order); Fst atol 2e-3 (the float32 cancellation budget of the reference);
S, carriers and integer columns exact; NaN at the same places.  The long
window's sim exactly equal, its sum rtol 1e-6 of the exact sum.  The
oracle copy equals tests/oracle.py exactly."""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle as test_oracle
from impop_tpu_torch.bench import inputs
from impop_tpu_torch.bench import main as bm
from impop_tpu_torch.bench import oracle as port_oracle
from impop_tpu_torch.stats.allele import identity_from_alleles as port_identity

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "vs_baseline_detail",
              "e2e", "long_window", "ehh", "ehh_fused"}
SMALL = ["--device", "cpu", "--batch", "2", "--iters", "1", "--e2e-batch",
         "2", "--e2e-mb", "0.01", "--long-shape", "64", "256", "2",
         "--ehh-batch", "2", "--baseline-windows", "1",
         "--baseline-passes", "1"]


@pytest.fixture(scope="module")
def bench_py():
    """The repository's bench.py as a module (it is not a package)."""
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tensors(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("seed", [42, 99])
def test_hprc_batch_equals_synth_batch(bench_py, seed):
    got = inputs.hprc_batch(np.random.default_rng(seed), 3)
    want = bench_py.synth_batch(np.random.default_rng(seed), w=3)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert bm.PAIRS == bench_py.PAIRS
    assert inputs.PANEL_SIZES == bench_py.PANEL_SIZES


def test_device_step_matches_bench_py(bench_py):
    batch = inputs.hprc_batch(np.random.default_rng(42), 3)
    got = [t.numpy() for t in bm.device_step(*tensors(*batch))]
    want = [np.asarray(x) for x in
            bench_py.device_pipeline()(*(jnp.asarray(a) for a in batch))]
    names = ("pi/length", "D", "Fst", "FstG", "Fst3", "S")
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
        if name == "S":
            np.testing.assert_array_equal(g, w)
        elif name.startswith("Fst"):
            np.testing.assert_allclose(g, w, atol=2e-3, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=name)


def test_ehh_fused_step_matches_jax():
    """bench.py's ehh_fused composition (bench.py:271-279) under JAX."""
    from impop_tpu.stats.ehh import ehh_area_dynamic
    from impop_tpu.stats.panelstats import fused_window_stats

    rng = np.random.default_rng(17)
    batch = inputs.hprc_batch(rng, 2)
    focals = rng.integers(0, 20, size=2).astype(np.int32)
    pair_a, pair_b = jnp.asarray(bm.PAIR_A), jnp.asarray(bm.PAIR_B)

    def one_window(g, m, sm, p1, ln, fi):
        _s, _p, s_countf, res = fused_window_stats(
            g, m, sm, ln, p1, pair_a, pair_b, jnp.float32(inputs.THRESHOLD),
            pairs_disjoint=True, return_matrices=False)
        xb = (g == 1).astype(jnp.int8)
        area, carr = ehh_area_dynamic(xb, m, sm, fi, alleles=(0, 1))
        return jnp.concatenate([
            res.pi, res.hudson.fst, res.hudson_grouped.fst,
            area, carr.astype(jnp.float32), s_countf.reshape(1)])

    want = np.asarray(jax.jit(jax.vmap(one_window))(
        *(jnp.asarray(a) for a in (*batch, focals))))
    got = bm.ehh_fused_step(*tensors(*batch, focals)).numpy()
    assert got.shape == want.shape
    pq, q = 15, 10
    np.testing.assert_allclose(got[:, :pq], want[:, :pq], rtol=1e-5)
    np.testing.assert_allclose(got[:, pq:pq + 2 * q], want[:, pq:pq + 2 * q],
                               atol=2e-3)
    area = slice(pq + 2 * q, pq + 2 * q + 2)
    np.testing.assert_allclose(got[:, area], want[:, area], rtol=1e-5)
    np.testing.assert_array_equal(got[:, area.stop:], want[:, area.stop:])


def test_long_window_step_matches_jax():
    """The step's sum of sim against the float64 sum of the JAX identity
    (its elements equal the port's bit for bit; JAX's own float32 sum of
    these 4096 elements is 1.1e-6 off the exact one), S exact."""
    from impop_tpu.stats.allele import identity_from_alleles, segregating_sites

    g, m, sm = bm.long_inputs(64, 256, 2)

    def one(g1, m1, sm1):
        sim, _ = identity_from_alleles(g1, m1, sm1, jnp.float32(bm.LONG_BP))
        return sim, segregating_sites(g1, m1, sm1)

    want_sim, want_s = (np.asarray(x) for x in jax.jit(jax.vmap(one))(
        jnp.asarray(g), jnp.asarray(m), jnp.asarray(sm)))
    got_sim, _ = port_identity(*tensors(g, m, sm), bm.LONG_BP)
    np.testing.assert_array_equal(got_sim.numpy(), want_sim)
    got_sum, got_s = bm.long_window_step(*tensors(g, m, sm))
    np.testing.assert_allclose(got_sum.numpy(),
                               want_sim.astype(np.float64).sum((1, 2)),
                               rtol=1e-6)
    np.testing.assert_array_equal(got_s.numpy(), want_s)


def test_bench_runs_small_without_jax():
    """``python -m impop_tpu_torch.bench --device cpu`` at a small size: one
    JSON line with bench.py's keys and ``device``, no regime an error, and
    neither jax nor impop_tpu loaded."""
    code = ("import runpy, sys\n"
            "sys.argv = ['impop_tpu_torch.bench'] + sys.argv[1:]\n"
            "try:\n"
            "    runpy.run_module('impop_tpu_torch.bench', "
            "run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    if e.code:\n"
            "        raise\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'impop_tpu',"
            " 'bench', 'oracle') or m.startswith(('jax.', 'impop_tpu.')))\n"
            "print('forbidden:', bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code, *SMALL], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, proc.stdout
    out = json.loads(lines[0])
    assert set(out) == BENCH_KEYS | {"device"}
    assert out["device"]["type"] == "cpu"
    for key in ("e2e", "long_window", "ehh", "ehh_fused"):
        assert "error" not in out[key], (key, out[key])
    assert out["value"] > 0 and out["vs_baseline"] > 0
    assert out["e2e"]["windows"] == 2
    assert out["long_window"]["peak"] == "int8"
    assert "forbidden: []" in proc.stdout, proc.stdout


def test_failing_regime_ends_the_run(monkeypatch, capsys):
    """A regime that raises is not caught: the run ends with its error and
    prints no result."""
    def broken(*args, **kwargs):
        raise RuntimeError("ehh regime broke")

    monkeypatch.setattr(bm, "bench_ehh", broken)
    monkeypatch.setattr(bm, "python_reference_rate", lambda *a: 1.0)
    with pytest.raises(RuntimeError, match="ehh regime broke"):
        bm.main(SMALL)
    assert "{" not in capsys.readouterr().out


def oracle_inputs(seed, n=14):
    """A similarity dict with missing pairs, two overlapping populations."""
    rng = np.random.default_rng(seed)
    names = [f"h{i:02d}" for i in range(n)]
    sims = {}
    for i in range(n):
        for j in range(i + 1, n):
            if rng.random() < 0.9:
                sims[(names[i], names[j])] = float(
                    rng.choice([0.9995, 0.9991, 0.998, 0.99]))
    return sims, names[:8], names[5:]


ORACLE_CALLS = {
    "greedy_groups": lambda o, d, a, b: o.greedy_groups(d, a + b, 0.999),
    "greedy_groups_rounded": lambda o, d, a, b: o.greedy_groups(
        d, a, 0.999, round_digits=3),
    "pica2_pi": lambda o, d, a, b: o.pica2_pi(d, a, 0.999, round_digits=4,
                                              sequence_length=5000),
    "direct_diversity": lambda o, d, a, b: o.direct_diversity(d, a, b),
    "hudson_fst_direct": lambda o, d, a, b: o.hudson_fst_direct(d, a, b),
    "hud_grouped_diversity": lambda o, d, a, b: o.hud_grouped_diversity(
        d, a, 0.999),
    "hud_grouped_dxy": lambda o, d, a, b: o.hud_grouped_dxy(d, a, b, 0.999),
    "hudson_fst_grouped": lambda o, d, a, b: o.hudson_fst_grouped(
        d, a, b, 0.999),
    "tajimas_d": lambda o, d, a, b: (o.tajimas_d(len(a), 7.0, 0.0012),
                                     o.tajimas_d(len(b), 0.0, 0.0)),
}


@pytest.mark.parametrize("name", sorted(ORACLE_CALLS))
@pytest.mark.parametrize("seed", [3, 4])
def test_oracle_copy_matches_tests_oracle(name, seed):
    d, a, b = oracle_inputs(seed)
    got = ORACLE_CALLS[name](port_oracle, d, a, b)
    want = ORACLE_CALLS[name](test_oracle, d, a, b)
    assert repr(got) == repr(want)
