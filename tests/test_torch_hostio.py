"""The port's host layer (``impop_tpu_torch.io``, ``.extract``, ``.report``
and ``.hostio``) against the JAX package's originals it was copied from,
on the same inputs made from a numpy seed.

The two packages have classes of their own (``Region``,
``SimilarityMatrix``, ``WindowMatrix``), so results are compared field by
field, never by type.  Every comparison is exact: the copies must compute
what the originals compute, byte for byte where they write bytes."""
from __future__ import annotations

import argparse
import dataclasses
import os
import shutil

import numpy as np
import pytest

import impop_tpu.cli as jcli
from impop_tpu.extract import gfa as jgfa
from impop_tpu.extract import pyfallback as jpyf
from impop_tpu.extract import simulate as jsimulate
from impop_tpu.extract import site_weights_from_keys as j_site_weights
from impop_tpu.extract import split_window_matrix as j_split
from impop_tpu.io import bed as jbed
from impop_tpu.io import bgzf as jbgzf
from impop_tpu.io import panels as jpanels
from impop_tpu.io import simtsv as jsimtsv
from impop_tpu.report import tables as jtables
from impop_tpu_torch import hostio
from impop_tpu_torch.extract import gfa as tgfa
from impop_tpu_torch.extract import pyfallback as tpyf
from impop_tpu_torch.extract import simulate as tsimulate
from impop_tpu_torch.extract import site_weights_from_keys as t_site_weights
from impop_tpu_torch.extract import split_window_matrix as t_split
from impop_tpu_torch.io import bed as tbed
from impop_tpu_torch.io import bgzf as tbgzf
from impop_tpu_torch.io import panels as tpanels
from impop_tpu_torch.io import simtsv as tsimtsv
from impop_tpu_torch.report import tables as ttables

HAVE_TOOLCHAIN = shutil.which("make") and shutil.which("g++")
SEEDS = [0, 1, 2]


def _fields(obj) -> dict:
    """A dataclass or NamedTuple as a plain dict of its fields."""
    if dataclasses.is_dataclass(obj):
        return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    return dict(obj._asdict())


def _assert_same(a, b):
    """Field-by-field equality of two objects of sibling classes."""
    fa, fb = _fields(a), _fields(b)
    assert fa.keys() == fb.keys()
    for key in fa:
        va, vb = fa[key], fb[key]
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype, key
            np.testing.assert_array_equal(va, vb, err_msg=key)
        else:
            assert va == vb, key


# ------------------------------------------------------------------ io.bed


def _write_bed(path, rng):
    lines = ["# header", ""]
    for k in range(40):
        chrom = f"CHM13#0#chr{rng.integers(1, 4)}" if k % 3 else "chr2"
        start = int(rng.integers(0, 10_000))
        end = start + int(rng.integers(-5, 5_000))  # some non-positive
        row = [chrom, str(start), str(end)]
        if k % 4 == 0:
            row.append(f"w{k}")
        if k % 11 == 0:
            row = row[:2]  # too short: skipped
        lines.append("\t".join(row))
    lines.append("chr1\tx\t10")
    path.write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("seed", SEEDS)
def test_read_bed_and_region_strings(tmp_path, seed):
    rng = np.random.default_rng(seed)
    bed = tmp_path / "w.bed"
    _write_bed(bed, rng)
    jr, tr = jbed.read_bed(bed), tbed.read_bed(bed)
    assert len(jr) == len(tr) > 0
    for a, b in zip(jr, tr):
        _assert_same(a, b)
        assert a.length == b.length
        for prefix in ("", "CHM13#0#", "HG1#1#"):
            assert a.region_string(prefix) == b.region_string(prefix)
            text = a.region_string(prefix)
            _assert_same(jbed.parse_region(text), tbed.parse_region(text))


@pytest.mark.parametrize("width", [1, 7, 1000, 5000])
def test_make_windows(width):
    for a, b in zip(jbed.make_windows("chr1", 13, 9_001, width),
                    tbed.make_windows("chr1", 13, 9_001, width),
                    strict=True):
        _assert_same(a, b)


def test_parse_region_errors():
    for bad in ("chr1", "chr1:10", ":1-2"):
        with pytest.raises(ValueError):
            jbed.parse_region(bad)
        with pytest.raises(ValueError):
            tbed.parse_region(bad)


# ---------------------------------------------------------------- io.panels


def _seq_names(rng, n):
    out = []
    for k in range(n):
        sample = f"HG{rng.integers(0, 30):05d}"
        out.append(f"{sample}#{1 + k % 2}#JA{rng.integers(0, 99)}:0-100")
    return sorted(set(out))


@pytest.mark.parametrize("seed", SEEDS)
def test_panels_expand_and_read(tmp_path, seed):
    rng = np.random.default_rng(seed)
    names = _seq_names(rng, 60)
    samples = sorted({n.split("#")[0] for n in names})
    raw = ([samples[0], samples[1] + "_hap1", samples[2] + "_pat",
            samples[3] + "_hprc_v1", samples[4] + "#1", "HG99999", "#skip",
            ""] + list(rng.choice(samples, 5)))
    assert jpanels.expand_population(raw, names) == \
        tpanels.expand_population(raw, names)
    for ident in raw:
        assert jpanels.canonicalize_identifier(ident) == \
            tpanels.canonicalize_identifier(ident)
    panel = tmp_path / "agc.EUR"
    panel.write_text("# comment\n" + "\n".join(raw) + "\n\n")
    assert jpanels.read_panel_file(panel) == tpanels.read_panel_file(panel)
    half = len(raw) // 2
    assert jpanels.union_panel(raw[:half], raw[half:]) == \
        tpanels.union_panel(raw[:half], raw[half:])


# ---------------------------------------------------------------- io.simtsv


def _sim_tsv(path, rng, n=9, missing=3):
    names = [f"HG{k:05d}#1#c:0-1" for k in range(n)]
    rows = ["group.a\tgroup.b\testimated.identity"]
    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    drop = set(rng.choice(len(pairs), missing, replace=False).tolist())
    for k, (i, j) in enumerate(pairs):
        if k in drop:
            continue
        a, b = (names[i], names[j]) if k % 2 else (names[j], names[i])
        rows.append(f"{a}\t{b}\t{rng.uniform(0.99, 1.0):.9f}")
    rows.append(f"{names[0]}\t{names[0]}\t1")
    path.write_text("\n".join(rows) + "\n")


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("digits", [None, 3, 5])
def test_similarity_tsv_round_trip(tmp_path, seed, digits):
    rng = np.random.default_rng(seed)
    src = tmp_path / "w.sim"
    _sim_tsv(src, rng)
    jm = jsimtsv.read_similarity_tsv(str(src), digits)
    tm = tsimtsv.read_similarity_tsv(str(src), digits)
    _assert_same(jm, tm)
    for d in (None, 2, 6):
        _assert_same(jm.rounded(d), tm.rounded(d))
    sub = jm.names[::2]
    np.testing.assert_array_equal(jm.mask_for(sub), tm.mask_for(sub))
    jsimtsv.write_similarity_tsv(jm, tmp_path / "j.tsv")
    tsimtsv.write_similarity_tsv(tm, tmp_path / "t.tsv")
    assert (tmp_path / "j.tsv").read_bytes() == \
        (tmp_path / "t.tsv").read_bytes()


@pytest.mark.parametrize("digits", [0, 3, 5, 8])
def test_round_half_even(digits):
    rng = np.random.default_rng(digits)
    vals = np.concatenate([rng.uniform(0.9, 1.0, 500),
                           np.round(rng.uniform(0, 1, 100), digits + 1),
                           [0.5, 1.5, 2.5, 0.125, 0.375, -0.5]])
    np.testing.assert_array_equal(jsimtsv.round_half_even(vals, digits),
                                  tsimtsv.round_half_even(vals, digits))


# ---------------------------------------------------------------- tables


@pytest.mark.parametrize("seed", SEEDS)
def test_tables_text(seed):
    rng = np.random.default_rng(seed)
    f = [float(x) for x in rng.uniform(-1, 1, 8)]
    for mod in ("pi_table_header",):
        for ws in (True, False):
            assert getattr(jtables, mod)(ws) == getattr(ttables, mod)(ws)
    for length in (None, 0, 5000):
        assert jtables.format_pica_output(f[0], f[1], length) == \
            ttables.format_pica_output(f[0], f[1], length)
    for label in (None, "EUR"):
        for r in (None, 5):
            assert jtables.pi_row("r", label, 5000, 0.999, r, "x") == \
                ttables.pi_row("r", label, 5000, 0.999, r, "x")
            assert jtables.fst3pi_row("r", 10, 0.9, r, *f[:3]) == \
                ttables.fst3pi_row("r", 10, 0.9, r, *f[:3])
    assert jtables.fst3pi_row("r", 1, 0.9, None, f[0], f[1], 0.0) == \
        ttables.fst3pi_row("r", 1, 0.9, None, f[0], f[1], 0.0)
    assert jtables.hfst_row("r", 9, *f[:6]) == ttables.hfst_row("r", 9, *f[:6])
    for d in (f[2], float("nan"), None):
        assert jtables.tajd_row("r", 9, 40, 7, f[3], d) == \
            ttables.tajd_row("r", 9, 40, 7, f[3], d)
    clusters = [list(range(int(k))) for k in rng.integers(1, 9, 5)]
    assert jtables.afs_summary_rows(clusters) == \
        ttables.afs_summary_rows(clusters)
    for name in ("HFST_HEADER", "FST3PI_HEADER", "TAJD_HEADER",
                 "AFS_HEADER"):
        assert getattr(jtables, name) == getattr(ttables, name)


# ---------------------------------------------------------------- wire


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("use_weights,use_ehh", [(False, False),
                                                 (True, False),
                                                 (False, True),
                                                 (True, True)])
def test_pack_scan_batch_bytes(seed, use_weights, use_ehh):
    rng = np.random.default_rng(seed)
    w, cap_n, cap_s, p = 3, 64, 256, 4
    geno = rng.integers(-1, 2, (w, cap_n, cap_s)).astype(np.int8)
    member = rng.random((w, cap_n)) < 0.8
    smask = rng.random((w, cap_s)) < 0.9
    panels = rng.random((w, p, cap_n)) < 0.3
    lengths = rng.integers(1, 10**6, w)
    wts = rng.integers(1, 100_000, (w, cap_s)).astype(np.float32) \
        if use_weights else None
    focals = rng.integers(0, cap_s, w) if use_ehh else None
    jb = jcli.pack_scan_batch(geno, member, smask, panels, lengths, wts,
                              use_weights, focals)
    tb = hostio.pack_scan_batch(geno, member, smask, panels, lengths, wts,
                                use_weights, focals)
    assert jb.dtype == tb.dtype and jb.shape == tb.shape
    assert jb.tobytes() == tb.tobytes()
    assert jcli._scan_buf_layout(cap_n, cap_s, p, use_weights, use_ehh) == \
        hostio._scan_buf_layout(cap_n, cap_s, p, use_weights, use_ehh)
    assert jb.shape[1] == hostio._scan_buf_layout(
        cap_n, cap_s, p, use_weights, use_ehh)["total"]


def test_pack_scan_batch_refuses_multiallelic():
    geno = np.zeros((1, 8, 128), np.int8)
    geno[0, 0, 0] = 2
    args = (geno, np.ones((1, 8), bool), np.ones((1, 128), bool),
            np.zeros((1, 1, 8), bool), np.ones(1), None, False)
    with pytest.raises(SystemExit):
        jcli.pack_scan_batch(*args)
    with pytest.raises(SystemExit):
        hostio.pack_scan_batch(*args)


def test_small_helpers():
    for ns in ([1], [63], [64], [65], [127], [129, 3], [512], [513]):
        assert jcli._capacity_for(ns) == hostio._capacity_for(ns)
        assert jcli._capacity_for(ns, 8) == hostio._capacity_for(ns, 8)
    for path in ("agc.EUR", "dir/panA.txt", "x.samples", "a.b.AFR", "plain"):
        assert jcli._panel_label(path) == hostio._panel_label(path)
    for region in ("CHM13#0#chr1:0-100", "a-b:c"):
        assert jcli._sanitize(region) == hostio._sanitize(region)


def test_shared_arguments():
    def parse(mod, argv):
        p = argparse.ArgumentParser()
        mod._add_common(p)
        mod._add_sim_args(p)
        return vars(p.parse_args(argv))

    for argv in (["-b", "w.bed"],
                 ["-b", "w.bed", "-P", "", "-r", "5", "-t", "0.99",
                  "--geno-dir", "g", "--identity-mode", "columns",
                  "--paf", "a.paf", "--agc", "x.agc", "--use-impg"]):
        assert parse(jcli, argv) == parse(hostio, argv)


def test_window_log_text(tmp_path):
    payload = {"pi": 0.25, "groups": [1, 2], "n": 7}
    jcli._write_window_log(str(tmp_path / "j"), "CHM13#0#chr1:0-9", "T",
                           payload)
    hostio._write_window_log(str(tmp_path / "t"), "CHM13#0#chr1:0-9", "T",
                             payload)
    name = "CHM13_0_chr1_0_9.log"
    assert (tmp_path / "j" / name).read_bytes() == \
        (tmp_path / "t" / name).read_bytes()


# ---------------------------------------------------------------- simulate


@pytest.mark.parametrize("kwargs", [
    dict(ref_len=1500, n_haps=6, n_snps=5, seed=3),
    dict(ref_len=4000, n_haps=9, seed=7, site_pool=40),
    dict(ref_len=3000, n_haps=5, seed=1, span=(200, 2800), p_indel=0.9),
])
def test_simulate_arrays(tmp_path, kwargs):
    js = jsimulate.simulate(str(tmp_path / "j"), **kwargs)
    ts = tsimulate.simulate(str(tmp_path / "t"), **kwargs)
    assert js.ref_name == ts.ref_name and js.ref_seq == ts.ref_seq
    assert len(js.haplotypes) == len(ts.haplotypes)
    for a, b in zip(js.haplotypes, ts.haplotypes):
        _assert_same(a, b)
    for attr in ("fasta_path", "paf_path"):
        with open(getattr(js, attr), "rb") as fa, \
                open(getattr(ts, attr), "rb") as fb:
            assert fa.read() == fb.read()


# ---------------------------------------------------------------- alleles


@pytest.mark.parametrize("seed", SEEDS)
def test_split_multiallelic(seed):
    rng = np.random.default_rng(seed)
    geno = rng.integers(-1, 4, (12, 30)).astype(np.int8)
    geno[:, :10] = np.clip(geno[:, :10], -1, 1)
    keys = [f"{100 + 3 * c}:A>{'C' * (1 + c % 3)}" for c in range(30)]
    for k in (keys, None):
        jg, jk = jcli.split_multiallelic(geno, k)
        tg, tk = hostio.split_multiallelic(geno, k)
        np.testing.assert_array_equal(jg, tg)
        assert jg.dtype == tg.dtype and jk == tk
    bi = np.clip(geno, -1, 1)
    assert hostio.split_multiallelic(bi, keys)[0] is bi


@pytest.mark.parametrize("seed", SEEDS)
def test_site_weights_and_split_window(seed):
    rng = np.random.default_rng(seed)
    s = 25
    pos = np.sort(rng.choice(5000, s, replace=False)).astype(np.int64)
    keys = []
    for k, p in enumerate(pos):
        kind = k % 4
        keys.append(f"{p}:A>C" if kind == 0 else f"{p}:>GGT" if kind == 1
                    else f"{p}:ACGTA>" if kind == 2 else f"{p}:A><INS{k}>")
    np.testing.assert_array_equal(j_site_weights(keys), t_site_weights(keys))
    geno = rng.integers(-1, 2, (6, s)).astype(np.int8)
    names = [f"h{k}:0-5000" for k in range(6)]
    jwm = j_split.__globals__["WindowMatrix"](names, keys, pos, geno)
    twm = t_split.__globals__["WindowMatrix"](names, keys, pos, geno)
    wins = [(0, 1000), (1000, 2500), (2500, 5000), (int(pos[3]), int(pos[9]))]
    for a, b in zip(j_split(jwm, wins), t_split(twm, wins), strict=True):
        _assert_same(a, b)


def _npz_dir(tmp_path, rng, regions, multi=False):
    d = tmp_path / "tiles"
    d.mkdir()
    for k, reg in enumerate(regions):
        n, s = 7 + k, 11 + 2 * k
        hi = 3 if multi else 2
        geno = rng.integers(-1, hi, (n, s)).astype(np.int8)
        names = np.array([f"HG{j:05d}#1#c:0-9" for j in range(n)])
        kw = dict(geno=geno, names=names[rng.permutation(n)])
        if k % 2 == 0:
            kw["site_keys"] = np.array([f"{10 + c}:A>T" for c in range(s)])
        name = reg if k % 3 else hostio._sanitize(reg)
        np.savez(d / f"{name}.npz", **kw)
    return str(d)


@pytest.mark.parametrize("seed", SEEDS)
def test_geno_source_loads(tmp_path, seed):
    rng = np.random.default_rng(seed)
    regions = [f"CHM13#0#chr1:{k * 1000}-{(k + 1) * 1000}" for k in range(4)]
    d = _npz_dir(tmp_path, rng, regions, multi=seed == 2)
    js, ts = jcli.GenoSource(d), hostio.GenoSource(d)
    for reg in regions:
        (jg, jn, jk), (tg, tn, tk) = js.load(reg), ts.load(reg)
        np.testing.assert_array_equal(jg, tg)
        assert jg.dtype == tg.dtype and jn == tn and jk == tk
    with pytest.raises(hostio.WindowError):
        ts.load("chr9:0-1")
    with pytest.raises(jcli.WindowError):
        js.load("chr9:0-1")


def test_gfa_dir_source_loads(tmp_path):
    sim = jsimulate.simulate(str(tmp_path / "sim"), ref_len=3000, n_haps=6,
                             seed=11, site_pool=30)
    wm = jpyf.PyExtractor(sim.paf_path, sim.fasta_path).extract(
        sim.ref_name, 500, 2500)
    gdir = tmp_path / "gfa"
    gdir.mkdir()
    region = f"{sim.ref_name}:500-2500"
    text = jgfa.window_to_gfa(wm, sim.ref_seq[500:2500], 500, sim.ref_name)
    assert text == tgfa.window_to_gfa(wm, sim.ref_seq[500:2500], 500,
                                      sim.ref_name)
    (gdir / f"{hostio._sanitize(region)}.gfa").write_text(text)
    (jg, jn, jk) = jcli.GfaDirSource(str(gdir)).load(region)
    (tg, tn, tk) = hostio.GfaDirSource(str(gdir)).load(region)
    np.testing.assert_array_equal(jg, tg)
    assert jn == tn and jk == tk and len(jk) > 0


@pytest.mark.parametrize("seed", SEEDS)
def test_load_windows_and_dir_sim_source(tmp_path, seed, capsys):
    rng = np.random.default_rng(seed)
    sims = tmp_path / "sims"
    sims.mkdir()
    regs = [jbed.Region("chr1", k * 100, (k + 1) * 100) for k in range(5)]
    for k, reg in enumerate(regs):
        if k == 2:
            continue  # a missing window: skipped with a warning
        rs = reg.region_string("CHM13#0#")
        name = f"{rs}.sim" if k % 2 else f"{hostio._sanitize(rs)}.tsv"
        _sim_tsv(sims / name, rng, n=5, missing=1)
    tregs = [tbed.Region(r.chrom, r.start, r.end) for r in regs]
    jk, jm, js = jcli._load_windows(regs, jcli.DirSimSource(str(sims), 4),
                                    "CHM13#0#")
    jerr = capsys.readouterr().err
    tk, tm, ts = hostio._load_windows(
        tregs, hostio.DirSimSource(str(sims), 4), "CHM13#0#")
    assert capsys.readouterr().err == jerr
    assert js == ts and len(jk) == len(tk) == 4
    for a, b in zip(jk, tk):
        _assert_same(a, b)
    for a, b in zip(jm, tm):
        _assert_same(a, b)


# ---------------------------------------------------------------- extractors


@pytest.fixture(scope="module")
def pangenome(tmp_path_factory):
    d = tmp_path_factory.mktemp("pg")
    return jsimulate.simulate(str(d), ref_len=4000, n_haps=8, seed=5,
                              site_pool=50, p_indel=0.6)


WINDOWS = [(0, 4000), (100, 1400), (1400, 2100), (3000, 3999)]


def test_py_extractor_windows(pangenome):
    jx = jpyf.PyExtractor(pangenome.paf_path, pangenome.fasta_path)
    tx = tpyf.PyExtractor(pangenome.paf_path, pangenome.fasta_path)
    for start, end in WINDOWS:
        a = jx.extract(pangenome.ref_name, start, end)
        b = tx.extract(pangenome.ref_name, start, end)
        _assert_same(a, b)
        assert a.geno.shape[1] > 0


@pytest.mark.skipif(not HAVE_TOOLCHAIN, reason="no C++ toolchain")
def test_native_extractor_matches_jax(pangenome):
    from impop_tpu.extract import NativeExtractor as JNative
    from impop_tpu_torch.extract import NativeExtractor as TNative
    from impop_tpu_torch.extract import library_path

    path = library_path()
    assert os.path.dirname(path).endswith(os.path.join("impop_tpu_torch",
                                                       "_build"))
    with JNative(pangenome.paf_path, pangenome.fasta_path) as jx, \
            TNative(pangenome.paf_path, pangenome.fasta_path) as tx:
        for start, end in WINDOWS:
            _assert_same(jx.extract(pangenome.ref_name, start, end),
                         tx.extract(pangenome.ref_name, start, end))
        jb = jx.extract_batch(pangenome.ref_name, WINDOWS[1:])
        tb = tx.extract_batch(pangenome.ref_name, WINDOWS[1:])
        for a, b in zip(jb, tb, strict=True):
            _assert_same(a, b)
        jp = jx.extract_batch_padded(pangenome.ref_name, WINDOWS[1:],
                                     want_weights=True)
        tp = tx.extract_batch_padded(pangenome.ref_name, WINDOWS[1:],
                                     want_weights=True)
        for a, b in zip(jp, tp, strict=True):
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b
    opened = hostio._open_extractor(pangenome.paf_path, pangenome.fasta_path)
    assert type(opened).__name__ == "NativeExtractor"
    assert type(opened).__module__ == "impop_tpu_torch.extract"
    opened.close()


@pytest.mark.skipif(not HAVE_TOOLCHAIN, reason="no C++ toolchain")
@pytest.mark.parametrize("n_records,preset", [(2 ** 40, None),
                                              (2 ** 58, "1")])
def test_native_extractor_bypasses_overclaiming_sidecar(tmp_path,
                                                         monkeypatch,
                                                         n_records, preset):
    """A sidecar with a valid header whose record count cannot fit its
    bytes: the open reparses the PAF and gives the windows of
    IMPOP_PAF_INDEX=0, leaves the sidecar byte for byte as it was and
    restores the environment."""
    import struct

    from impop_tpu_torch.extract import NativeExtractor

    sim = tsimulate.simulate(str(tmp_path), ref_len=4000, n_haps=8, seed=7,
                             site_pool=50, p_indel=0.6)

    def windows():
        with NativeExtractor(sim.paf_path, sim.fasta_path) as ex:
            return [ex.extract(sim.ref_name, lo, hi) for lo, hi in WINDOWS]

    monkeypatch.delenv("IMPOP_PAF_INDEX", raising=False)
    windows()                               # writes the sidecar
    idx = sim.paf_path + ".impopidx"
    raw = bytearray(open(idx, "rb").read())
    assert raw[:4] == b"IPXI" and len(raw) < n_records
    raw[32:40] = struct.pack("<Q", n_records)
    with open(idx, "wb") as fh:
        fh.write(raw)
    if preset is not None:
        monkeypatch.setenv("IMPOP_PAF_INDEX", preset)
    got = windows()
    assert os.environ.get("IMPOP_PAF_INDEX") == preset
    assert open(idx, "rb").read() == bytes(raw)
    monkeypatch.setenv("IMPOP_PAF_INDEX", "0")
    for a, b in zip(got, windows(), strict=True):
        _assert_same(a, b)
        assert a.geno.shape[1] > 0


# ---------------------------------------------------------------- bgzf


@pytest.mark.parametrize("seed", SEEDS)
def test_bgzf_bytes(tmp_path, seed):
    rng = np.random.default_rng(seed)
    chunks = [">c\n" + "".join(rng.choice(list("ACGT"), int(k))) + "\n"
              for k in rng.integers(1, 90_000, 4)]
    jbgzf.write_bgzf(str(tmp_path / "j.gz"), chunks)
    tbgzf.write_bgzf(str(tmp_path / "t.gz"), chunks)
    assert (tmp_path / "j.gz").read_bytes() == (tmp_path / "t.gz").read_bytes()
    assert jbgzf.bgzf_block(b"abc") == tbgzf.bgzf_block(b"abc")
