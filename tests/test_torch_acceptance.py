"""The JAX package's adversarial acceptance run
(``tests/test_acceptance_hostile.py``) on the port, with ``--device cpu``.

The same hostile chromosome (ragged coverage, ``p_indel=0.7``, strand
flips, a window past every alignment and a ghost panel) goes through the
port's ``scan --ehh``: every window with data is pinned to
``tests/oracle.py`` (S exact, π within 1e-4 relative or 1e-3 absolute,
the ghost panel's π 0, direct and grouped Fst within 2e-3), and the table
is held to the JAX ``scan``'s on the same inputs
(``test_torch_cli.assert_tables_close``: integers exact, π / D / EHH rtol
1e-5, Fst atol 2e-3, NA in the same cells), with ``--identity-mode
columns --afs`` too (spectrum files byte-identical).  The crafted tiles
(a multiallelic column split for the 2-bit wire, disjoint coverage that
trips the seed_risk recompute, a missing tile that takes the NA path) and
the workflow extract → panels-tajd → panels-hfst → sfs → plot follow, each
against the oracle or the JAX command's files.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import oracle
from impop_tpu.cli import main as jax_main
from impop_tpu_torch.cli import main as torch_main
from test_torch_cli import assert_tables_close

torch.set_num_threads(1)

# the oracle compares against the threshold the device compares with (the
# float32 value of 0.999), as in the JAX test
T32 = float(np.float32(0.999))


@pytest.fixture(scope="module")
def hostile(tmp_path_factory):
    from impop_tpu_torch.extract.simulate import simulate

    tmp = tmp_path_factory.mktemp("hostile")
    sim = simulate(str(tmp), ref_len=60_000, n_haps=20, site_pool=500,
                   p_indel=0.7, seed=23, span=None)
    bed = tmp / "w.bed"
    rows = [f"chr1\t{lo}\t{lo + 3000}\n" for lo in range(0, 60_000, 3000)]
    rows.append("chr1\t90000\t93000\n")      # past every alignment: n = 0
    bed.write_text("".join(rows))
    samples = sorted({h.name.split("#")[0] for h in sim.haplotypes})
    (tmp / "agc.PA").write_text("\n".join(samples[:4]) + "\n")
    (tmp / "agc.PB").write_text("\n".join(samples[4:8]) + "\n")
    (tmp / "agc.PG").write_text("ZZ99998\nZZ99999\n")   # ghost panel
    return sim, tmp, bed


def scan_argv(hostile, out, journal, flags):
    sim, tmp, bed = hostile
    argv = ["scan", "-b", str(bed), "--paf", sim.paf_path,
            "--fasta", sim.fasta_path, "-P", "CHM13#0#"]
    for p in ("PA", "PB", "PG"):
        argv += ["--panel", str(tmp / f"agc.{p}")]
    return argv + [*flags, "--journal", str(journal), "-o", str(out)]


def sim_dict(g, names, length):
    """{(a, b): f32 similarity} of every pair with a compared site, in
    sorted-name order, as the device computes it."""
    valid = g >= 0
    both = valid[:, None, :] & valid[None, :, :]
    dcount = ((g[:, None, :] != g[None, :, :]) & both).sum(-1)
    simm = np.float32(1.0) - dcount.astype(np.float32) / np.float32(length)
    comp = both.sum(-1)
    n = len(names)
    return {(names[i], names[j]): float(simm[i, j])
            for i in range(n) for j in range(i + 1, n) if comp[i, j] > 0}


def seg_sites(g):
    valid = g >= 0
    gmax = np.where(valid, g, -1).max(axis=0)
    gmin = np.where(valid, g, 127).min(axis=0)
    return int((valid.any(axis=0) & (gmax > gmin)).sum())


def test_hostile_scan_pins_oracle(hostile, tmp_path, capsys):
    """scan --ehh on the hostile chromosome: "success: 21, errors: 0", 21
    rows (the empty window an n = 0 row), every window with data pinned
    to the oracle through the port's native extraction."""
    from impop_tpu_torch.extract import NativeExtractor
    from impop_tpu_torch.io.panels import expand_population

    sim, tmp, _ = hostile
    out, journal = tmp_path / "scan.tsv", tmp_path / "scan.jsonl"
    capsys.readouterr()
    assert torch_main(scan_argv(hostile, out, journal,
                                ["--ehh", "--device", "cpu"])) == 0
    err = capsys.readouterr().err
    assert "success: 21, errors: 0" in err, err
    assert len(journal.read_text().splitlines()) >= 21
    lines = [ln.split("\t") for ln in out.read_text().splitlines() if ln]
    hdr, rows = lines[0], lines[1:]
    assert len(rows) == 21
    col = {name: hdr.index(name) for name in hdr}
    pa_list = (tmp / "agc.PA").read_text().split()
    pb_list = (tmp / "agc.PB").read_text().split()
    checked = 0
    with NativeExtractor(sim.paf_path, sim.fasta_path) as nat:
        for row in rows:
            start, end = map(int, row[0].rsplit(":", 1)[1].split("-"))
            wm = nat.extract("CHM13#0#chr1", start, end)
            order = np.argsort(wm.names)
            g = np.asarray(wm.geno)[order]
            names = [wm.names[i] for i in order]
            if g.shape[0] == 0:
                continue
            length = float(end - start)
            sd = sim_dict(g, names, length)
            assert int(row[col["SEGREGATING_SITES"]]) == seg_sites(g)
            stems = [nm.split(":", 1)[0] for nm in names]
            pa_m, _ = expand_population(pa_list, stems)
            pb_m, _ = expand_population(pb_list, stems)
            pa = [nm for nm, st in zip(names, stems) if st in pa_m]
            pb = [nm for nm, st in zip(names, stems) if st in pb_m]
            for pname, plist in (("PA", pa), ("PB", pb)):
                keep = set(plist)
                want, _ = oracle.pica2_pi(
                    {k: v for k, v in sd.items()
                     if k[0] in keep and k[1] in keep}, plist, T32)
                got = float(row[col[f"PI_{pname}"]]) * length
                assert abs(want - got) <= max(1e-4 * abs(want), 1e-3), (
                    row[0], pname, want, got)
            assert float(row[col["PI_PG"]]) == 0.0
            if pa and pb:
                w_d = oracle.hudson_fst_direct(sd, pa, pb)
                assert abs(w_d["fst"] - float(row[col["FST_PA_PB"]])) < 2e-3
                w_g = oracle.hudson_fst_grouped(sd, pa, pb, T32)
                assert abs(w_g["fst"] - float(row[col["FSTG_PA_PB"]])) < 2e-3
            checked += 1
    assert checked >= 10, "hostile windows mostly empty: fixture too weak"


@pytest.mark.parametrize("flags", [["--ehh"],
                                   ["--identity-mode", "columns", "--afs"]])
def test_hostile_scan_matches_jax(hostile, tmp_path, flags):
    """The port's table (and spectrum) equal the JAX scan's on the hostile
    chromosome, in events mode with EHH and in columns mode."""
    outs = {}
    for side, main, extra in (("jax", jax_main, []),
                              ("torch", torch_main, ["--device", "cpu"])):
        out = tmp_path / f"{side}.tsv"
        fl = list(flags)
        if "--afs" in fl:
            fl.insert(fl.index("--afs") + 1, str(tmp_path / f"{side}.afs"))
        assert main(scan_argv(hostile, out, tmp_path / f"{side}.jsonl",
                              fl + extra)) == 0
        outs[side] = out
    assert_tables_close(outs["jax"], outs["torch"])
    if "--afs" in flags:
        assert ((tmp_path / "jax.afs").read_text()
                == (tmp_path / "torch.afs").read_text())


def crafted_tiles(tmp_path):
    """Three crafted windows as .npz tiles (multiallelic column, disjoint
    coverage) and a BED of four: the fourth has no tile on disk."""
    rng = np.random.default_rng(3)
    tiles = tmp_path / "tiles"
    tiles.mkdir()
    n, s = 12, 24
    names = [f"HG{90000 + i // 2:05d}#{i % 2 + 1}#c{i}" for i in range(n)]
    regions = []
    for wi in range(3):
        g = rng.integers(0, 2, size=(n, s)).astype(np.int8)
        g[:, 5] = rng.integers(0, 3, size=n)       # three alleles
        g[: n // 2, s // 2:] = -1                  # disjoint coverage
        g[n // 2:, : s // 2] = -1
        lo = wi * 1000
        region = f"chr1:{lo}-{lo + 1000}"
        keys = [f"{lo + 10 + 3 * k}:snp" for k in range(s)]
        np.savez(tiles / f"{region}.npz", geno=g, names=np.asarray(names),
                 site_keys=np.asarray(keys))
        regions.append((region, g))
    bed = tmp_path / "w.bed"
    bed.write_text("".join(f"chr1\t{wi * 1000}\t{wi * 1000 + 1000}\n"
                           for wi in range(4)))
    (tmp_path / "agc.QA").write_text(
        "\n".join(f"HG{90000 + i:05d}" for i in range(3)) + "\n")
    (tmp_path / "agc.QB").write_text(
        "\n".join(f"HG{90000 + i:05d}" for i in range(3, 6)) + "\n")
    return tiles, bed, names, regions


def test_hostile_crafted_tiles_multiallelic_and_seed_risk(tmp_path):
    """Multiallelic codes split for the 2-bit wire, disjoint coverage that
    must trip the exact-FSTG recompute (hud.py's first-found-pair oracle),
    and a missing tile: one NA journal record, three rows.  The table
    equals the JAX scan's."""
    from impop_tpu_torch.hostio import split_multiallelic

    tiles, bed, names, regions = crafted_tiles(tmp_path)
    outs = {}
    for side, main, extra in (("jax", jax_main, []),
                              ("torch", torch_main, ["--device", "cpu"])):
        outs[side] = tmp_path / f"{side}.tsv"
        assert main(["scan", "-b", str(bed), "--geno-dir", str(tiles),
                     "-P", "", "--panel", str(tmp_path / "agc.QA"),
                     "--panel", str(tmp_path / "agc.QB"), "--journal",
                     str(tmp_path / f"{side}.jsonl"), "-o",
                     str(outs[side]), *extra]) == 0
    assert_tables_close(outs["jax"], outs["torch"])
    lines = [ln.split("\t") for ln in outs["torch"].read_text().splitlines()
             if ln]
    hdr, rows = lines[0], lines[1:]
    col = {nm: hdr.index(nm) for nm in hdr}
    assert len(rows) == 3
    recs = (tmp_path / "torch.jsonl").read_text().splitlines()
    assert len([r for r in recs if "NA" in r]) == 1, recs

    n, s = 12, 24
    risk_hit = 0
    order = np.argsort(names)
    nms = [names[i] for i in order]
    qa = [nm for nm in nms if any(nm.startswith(f"HG{90000 + i:05d}#")
                                  for i in range(3))]
    qb = [nm for nm in nms if any(nm.startswith(f"HG{90000 + i:05d}#")
                                  for i in range(3, 6))]
    for (region, g), row in zip(regions, rows):
        g2, _ = split_multiallelic(g, [f"{k}:x" for k in range(s)])
        assert int(row[col["SEGREGATING_SITES"]]) == seg_sites(g2), region
        sd = sim_dict(g2[order], nms, 1000.0)
        assert len(sd) < n * (n - 1) // 2      # cross pairs lack data
        w_g = oracle.hudson_fst_grouped(sd, qa, qb, T32)
        got = float(row[col["FSTG_QA_QB"]])
        if not np.isnan(w_g["fst"]):
            assert abs(w_g["fst"] - got) < 2e-3, (region, w_g["fst"], got)
            risk_hit += 1
    assert risk_hit >= 1, "no crafted window exercised the grouped path"


def read_rows(path):
    return [ln.split("\t") for ln in path.read_text().splitlines() if ln]


def assert_stat_tables_close(path_a, path_b):
    """Per-statistic tables: text and integer columns exact, FST and DA
    atol 2e-3, the other floats rtol 1e-5, NA in the same cells."""
    rows_a, rows_b = read_rows(path_a), read_rows(path_b)
    assert rows_a[0] == rows_b[0] and len(rows_a) == len(rows_b)
    for ra, rb in zip(rows_a[1:], rows_b[1:]):
        for name, va, vb in zip(rows_a[0], ra, rb):
            assert (va == "NA") == (vb == "NA"), (name, ra[0])
            if va == "NA" or name in ("REGION", "LENGTH", "SAMPLES",
                                      "SEGREGATING_SITES"):
                assert va == vb, (name, ra[0])
            elif name in ("FST", "DA"):
                assert abs(float(va) - float(vb)) <= 2e-3, (name, va, vb)
            else:
                np.testing.assert_allclose(float(va), float(vb), rtol=1e-5,
                                           atol=1e-8, err_msg=name)


def test_hostile_full_workflow(hostile, tmp_path, monkeypatch):
    """extract → panels-tajd → panels-hfst → sfs → plot on the hostile
    chromosome, through each package in its own directory: the port's
    tiles, .tj, .fst and spectrum files equal the JAX ones, and the plot
    is written."""
    sim, _, bed = hostile
    samples = sorted({h.name.split("#")[0] for h in sim.haplotypes})
    md = tmp_path / "metadata"
    md.mkdir()
    for gi, grp in enumerate(("EUR", "AFR", "EAS", "SAS", "AMR")):
        (md / f"agc.{grp}").write_text(
            "\n".join(samples[2 * gi:2 * gi + 2]) + "\n")
    dirs = {}
    for side, main, extra in (("jax", jax_main, []),
                              ("torch", torch_main, ["--device", "cpu"])):
        d = tmp_path / side
        d.mkdir()
        monkeypatch.chdir(d)
        tiles = d / "tiles"
        assert main(["extract", "-b", str(bed), "--paf", sim.paf_path,
                     "--fasta", sim.fasta_path, "-P", "CHM13#0#",
                     "--out-dir", str(tiles)]) == 0
        assert len(list(tiles.glob("*.npz"))) >= 15
        common = ["-b", str(bed), "--geno-dir", str(tiles), "-P",
                  "CHM13#0#", *extra]
        assert main(["panels-tajd", *common, "--metadata-dir",
                     str(md)]) == 0
        assert main(["panels-hfst", *common, "--metadata-dir",
                     str(md)]) == 0
        assert main(["sfs", *common, "--panel", str(md / "agc.EUR"),
                     "--panel", str(md / "agc.AFR"), "-o",
                     str(d / "sfs.tsv")]) == 0
        dirs[side] = d
    ja, to = dirs["jax"], dirs["torch"]
    for fn in ("eur.tj", "afr.tj", "eas.tj", "sas.tj", "amr.tj"):
        table = (to / fn).read_text().splitlines()
        assert table[0].split("\t")[:4] == [
            "REGION", "LENGTH", "SAMPLES", "SEGREGATING_SITES"]
        assert len(table) >= 15
        assert_stat_tables_close(ja / fn, to / fn)
    fst_tables = sorted(p.name for p in to.glob("*.fst"))
    assert len(fst_tables) == 10
    assert fst_tables == sorted(p.name for p in ja.glob("*.fst"))
    for fn in fst_tables:
        assert (to / fn).read_text().split("\t")[:3] == [
            "REGION", "LENGTH", "FST"]
        assert_stat_tables_close(ja / fn, to / fn)
    sfs_lines = (to / "sfs.tsv").read_text().splitlines()
    assert sfs_lines[0].startswith("ALLELE_COUNT") and len(sfs_lines) > 1
    assert (ja / "sfs.tsv").read_text() == (to / "sfs.tsv").read_text()

    png = tmp_path / "tajd.png"
    assert torch_main(["plot", "tajd", "--input", f"EUR={to / 'eur.tj'}",
                       "--input", f"AFR={to / 'afr.tj'}", "--output",
                       str(png)]) == 0
    assert png.exists() and png.stat().st_size > 1000
