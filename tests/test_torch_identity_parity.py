"""Native identity on the port against the identity contract (the twin
of ``tests/test_identity_parity.py``): ``impop_tpu_torch.cli.GenoSimSource``
with ``device="cpu"`` and the port's Python extractor, ``simulate`` and
``io.simtsv.round_half_even``.

1. The spec on planted variants: a k-base indel costs one difference in
   events mode and k in columns mode; SNP-only windows agree in both
   modes; the integer counts on the device path reproduce a host-side
   numpy formulation exactly.
2. An alignment oracle (Needleman-Wunsch on the raw simulated sequences)
   bounds the deviation of the columns identity, independent of the
   engine's own diff formula.
3. A differential against a real ``impg similarity`` where the binary is
   on PATH (skipped otherwise, as in the JAX test).

Every matrix the port builds here is also held to the JAX package's
``GenoSimSource`` on the same inputs: names, sim and present identical.
"""
from __future__ import annotations

import shutil
import subprocess

import numpy as np
import pytest
import torch

from impop_tpu_torch.extract import site_weights_from_keys
from impop_tpu_torch.extract.pyfallback import PyExtractor
from impop_tpu_torch.extract.simulate import simulate

torch.set_num_threads(1)

HAVE_IMPG = shutil.which("impg") is not None


def identity_matrix(sim, region, mode, round_digits=None):
    """The port's identity matrix of ``region``, held to the JAX
    package's on the same inputs."""
    from impop_tpu.cli import GenoSimSource as JaxSource
    from impop_tpu_torch.cli import GenoSimSource

    got = GenoSimSource(round_digits, paf=sim.paf_path, fasta=sim.fasta_path,
                        use_native=False, identity_mode=mode,
                        device="cpu").load(region)
    want = JaxSource(round_digits, paf=sim.paf_path, fasta=sim.fasta_path,
                     use_native=False, identity_mode=mode).load(region)
    assert got.names == want.names
    np.testing.assert_array_equal(got.present, want.present)
    np.testing.assert_array_equal(got.sim, want.sim)
    return got


def test_event_vs_column_mode_on_planted_indel(tmp_path):
    """A k-base insertion costs 1 difference in events mode, k in columns
    mode; SNP-only pairs are identical in both modes."""
    sim = simulate(str(tmp_path), ref_len=2000, n_haps=6, n_snps=10,
                   p_indel=0.6, seed=77, span=(0, 2000))
    region = "CHM13#0#chr1:0-2000"
    ev = identity_matrix(sim, region, "events")
    co = identity_matrix(sim, region, "columns")
    assert ev.names == co.names

    wm = PyExtractor(sim.paf_path, sim.fasta_path).extract(sim.ref_name, 0,
                                                           2000)
    w = site_weights_from_keys(wm.site_keys)
    assert (w >= 1).all()
    assert (w > 1).any(), "fixture must plant at least one multi-base indel"
    g = np.asarray(wm.geno)[np.argsort(wm.names)]
    length = 2000.0
    n = g.shape[0]
    for i in range(n):
        for j in range(n):
            both = (g[i] >= 0) & (g[j] >= 0)
            neq = both & (g[i] != g[j])
            if i == j or not both.any():
                continue
            d_co = float(w[neq].sum()) if neq.any() else 0.0
            np.testing.assert_allclose(ev.sim[i, j],
                                       1.0 - float(neq.sum()) / length,
                                       atol=1e-12)
            np.testing.assert_allclose(co.sim[i, j], 1.0 - d_co / length,
                                       atol=1e-12)
    assert (co.sim <= ev.sim + 1e-12).all()


def test_snp_only_modes_agree(tmp_path):
    sim = simulate(str(tmp_path), ref_len=1500, n_haps=5, n_snps=12,
                   p_indel=0.0, seed=5, span=(0, 1500))
    region = "CHM13#0#chr1:0-1500"
    ev = identity_matrix(sim, region, "events")
    co = identity_matrix(sim, region, "columns")
    np.testing.assert_array_equal(ev.sim, co.sim)


def test_geno_sim_source_device_path_matches_reference_numpy(tmp_path):
    """The integer diff counts of the device path reproduce the host-side
    formulation exactly, through ``-r 5`` rounding half to even."""
    from impop_tpu_torch.io.simtsv import round_half_even

    sim = simulate(str(tmp_path), ref_len=2500, n_haps=8, n_snps=15,
                   p_indel=0.4, seed=13, span=(0, 2500))
    region = "CHM13#0#chr1:0-2500"
    got = identity_matrix(sim, region, "events", round_digits=5)

    wm = PyExtractor(sim.paf_path, sim.fasta_path).extract(sim.ref_name, 0,
                                                           2500)
    g = np.asarray(wm.geno, np.int16)[np.argsort(wm.names)]
    valid = g >= 0
    gg = np.where(valid, g, 0)
    compared = valid.astype(np.float64) @ valid.T
    match = np.zeros_like(compared)
    for a in range(int(gg.max(initial=0)) + 1):
        xa = ((gg == a) & valid).astype(np.float64)
        match += xa @ xa.T
    sim_ref = 1.0 - (compared - match) / 2500.0
    present = compared > 0
    np.fill_diagonal(present, True)
    sim_ref = np.where(present, sim_ref, 0.0)
    np.fill_diagonal(sim_ref, 1.0)
    np.testing.assert_array_equal(got.sim, round_half_even(sim_ref, 5))
    np.testing.assert_array_equal(got.present, present)


@pytest.mark.skipif(not HAVE_IMPG, reason="impg binary not on PATH")
def test_impg_similarity_differential(tmp_path):
    """Against a real impg: per-pair |ours - impg| within the documented
    deviation (indel-length excess / L)."""
    sim = simulate(str(tmp_path), ref_len=5000, n_haps=10, n_snps=20,
                   p_indel=0.3, seed=3, span=(0, 5000))
    region = "CHM13#0#chr1:0-5000"
    proc = subprocess.run(
        ["impg", "similarity", "-p", sim.paf_path, "-r", region,
         "--sequence-files", sim.fasta_path],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    theirs = {}
    for line in proc.stdout.splitlines()[1:]:
        a, b, ident = line.split("\t")[:3]
        theirs[frozenset((a, b))] = float(ident)
    ours = identity_matrix(sim, region, "columns")
    wm = PyExtractor(sim.paf_path, sim.fasta_path).extract(sim.ref_name, 0,
                                                           5000)
    bound = float(site_weights_from_keys(wm.site_keys).sum()) / 5000.0 + 1e-4
    checked = 0
    for i, a in enumerate(ours.names):
        for j in range(i + 1, len(ours.names)):
            key = frozenset((a, ours.names[j]))
            if key in theirs and ours.present[i, j]:
                assert abs(ours.sim[i, j] - theirs[key]) <= bound, key
                checked += 1
    assert checked > 0


# ---------------------------------------------------------------------------
# Alignment oracle: unit-cost global alignment of the raw sequences gives
# the true alignment-column identity (no impg needed).


def _nw_stats(a: str, b: str):
    """Unit-cost global alignment (mismatch=1, gap=1).

    Returns (matches, columns) along one optimal path (diagonal-preferring
    traceback).  Row DP is vectorised; the in-row left-gap dependence is
    resolved with the minimum.accumulate prefix trick.
    """
    n, m = len(a), len(b)
    av = np.frombuffer(a.encode(), np.uint8)
    bv = np.frombuffer(b.encode(), np.uint8)
    D = np.zeros((n + 1, m + 1), np.int32)
    D[0] = np.arange(m + 1)
    idx = np.arange(m + 1)
    for i in range(1, n + 1):
        sub = D[i - 1, :-1] + (av[i - 1] != bv)
        up = D[i - 1, 1:] + 1
        base = np.empty(m + 1, np.int32)
        base[0] = i
        base[1:] = np.minimum(sub, up)
        D[i] = np.minimum.accumulate(base - idx) + idx
    # traceback
    i, j = n, m
    matches = columns = 0
    while i > 0 or j > 0:
        if (i > 0 and j > 0
                and D[i, j] == D[i - 1, j - 1] + (av[i - 1] != bv[j - 1])):
            matches += int(av[i - 1] == bv[j - 1])
            i -= 1
            j -= 1
        elif i > 0 and D[i, j] == D[i - 1, j] + 1:
            i -= 1
        else:
            j -= 1
        columns += 1
    return matches, columns


def _read_fasta_raw(path):
    seqs, name = {}, None
    with open(path) as fh:
        for line in fh:
            if line.startswith(">"):
                name = line[1:].split()[0]
                seqs[name] = []
            else:
                seqs[name].append(line.strip())
    return {k: "".join(v) for k, v in seqs.items()}


def _read_fasta_raw(path):
    seqs, name = {}, None
    with open(path) as fh:
        for line in fh:
            if line.startswith(">"):
                name = line[1:].split()[0]
                seqs[name] = []
            else:
                seqs[name].append(line.strip())
    return {k: "".join(v) for k, v in seqs.items()}


def oracle_vs_ours(tmp_path, seed, p_indel, n_snps, ref_len=1200, n_haps=6,
                   site_pool=None):
    from impop_tpu_torch.extract.simulate import _revcomp

    sim = simulate(str(tmp_path), ref_len=ref_len, n_haps=n_haps,
                   n_snps=n_snps, p_indel=p_indel, seed=seed,
                   span=(0, ref_len), site_pool=site_pool)
    ours = identity_matrix(sim, f"CHM13#0#chr1:0-{ref_len}", "columns")
    raw = _read_fasta_raw(sim.fasta_path)
    seq_of = {f"{sim.ref_name}:0-{ref_len}": sim.ref_seq}
    for h in sim.haplotypes:
        contig = raw[h.name.split(":", 1)[0]] if h.name in raw else raw[h.name]
        seq_of[h.name] = _revcomp(contig) if h.reverse else contig
    rows = []
    for nm in ours.names:
        stem = nm.rsplit(":", 1)[0]
        rows.append(seq_of[stem] if stem in seq_of else seq_of[nm])
    return sim, ours, rows


def test_identity_matches_alignment_oracle_snp_only(tmp_path):
    """SNP-only shared-allele sites: the columns identity equals the
    alignment oracle's matches / columns (no gaps: columns == L)."""
    _, ours, rows = oracle_vs_ours(tmp_path, seed=21, p_indel=0.0, n_snps=0,
                                   site_pool=40)
    checked = 0
    for i in range(len(rows)):
        for j in range(i + 1, len(rows)):
            if not ours.present[i, j]:
                continue
            matches, columns = _nw_stats(rows[i], rows[j])
            assert columns == len(rows[i]) == len(rows[j])
            np.testing.assert_allclose(ours.sim[i, j], matches / columns,
                                       atol=1e-9)
            checked += 1
    assert checked >= 10


@pytest.mark.parametrize("seed", [3, 11, 29])
def test_identity_within_documented_bound_of_alignment_oracle(tmp_path, seed):
    """With planted indels: |ours - matches / columns| per pair within the
    total indel columns of either haplotype (simulation truth) / L."""
    sim, ours, rows = oracle_vs_ours(tmp_path, seed=seed, p_indel=0.5,
                                     n_snps=14, ref_len=1500)
    length = 1500.0
    budget = {f"{sim.ref_name}:0-1500": 0.0}
    for h in sim.haplotypes:
        budget[h.name] = float(sum(len(s) for s in h.insertions.values())
                               + sum(h.deletions.values()))
    names = [nm.rsplit(":", 1)[0] if nm.rsplit(":", 1)[0] in budget else nm
             for nm in ours.names]
    checked = indels_seen = 0
    for i in range(len(rows)):
        for j in range(i + 1, len(rows)):
            if not ours.present[i, j]:
                continue
            matches, columns = _nw_stats(rows[i], rows[j])
            bound = (budget[names[i]] + budget[names[j]] + 2.0) / length
            assert abs(ours.sim[i, j] - matches / columns) <= bound, (
                names[i], names[j], ours.sim[i, j], matches / columns)
            indels_seen += budget[names[i]] + budget[names[j]] > 0
            checked += 1
    assert checked >= 10 and indels_seen >= 5
