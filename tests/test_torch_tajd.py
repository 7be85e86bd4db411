"""The ``tajd`` slice of impop_tpu_torch against the JAX package (CPU
backend): ``greedy_group`` and ``rep_weights`` (bit-identical),
``pi_grouped`` and ``batch_tajd_from_alleles``, and the whole CLI
(``--geno-dir`` at S >= 2048, ``--gfa-dir``, ``-s``, ``-l``, ``--log-dir``,
``--stream-npy``) on the same tiles.

Tolerances: gid, seeds, n, S, group and pair counts exact; π and D rtol
1e-5 (float32 quadratic forms summed in another order); tables: REGION,
LENGTH, SAMPLES, SEGREGATING_SITES equal, PI (8 decimals) and TAJIMAS_D
rtol 1e-5, NA at the same places."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from impop_tpu.cli import main as jax_main
from impop_tpu.parallel.scan import batch_tajd_from_alleles as j_batch_tajd
from impop_tpu.stats import grouping as jg
from impop_tpu.stats.pi import pi_grouped as j_pi_grouped
from impop_tpu_torch.cli import main as torch_main
from impop_tpu_torch.parallel.scan import batch_tajd_from_alleles
from impop_tpu_torch.stats import grouping as tg
from impop_tpu_torch.stats.allele import identity_from_alleles
from impop_tpu_torch.stats.pi import pi_grouped

torch.set_num_threads(1)
THR = 0.999


def tiles(seed, w, n, s, n_classes=5, missing=0.03):
    rng = np.random.default_rng(seed)
    geno = np.full((w, n, s), -1, np.int8)
    for wi in range(w):
        cls = rng.integers(0, 2, size=(n_classes, s)).astype(np.int8)
        g = cls[rng.integers(0, n_classes, size=n)]
        geno[wi] = np.where(rng.random((n, s)) < 0.005, 1 - g, g)
    geno[rng.random(geno.shape) < missing] = -1
    member = np.ones((w, n), bool)
    member[:, -5:] = False
    geno[:, -5:] = -1
    smask = np.ones((w, s), bool)
    smask[:, -7:] = False
    return geno, member, smask


def identity(geno, member, smask, length):
    sim, pres = identity_from_alleles(
        torch.from_numpy(geno), torch.from_numpy(member),
        torch.from_numpy(smask), torch.tensor(length))
    return sim.numpy(), pres.numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_group_and_rep_weights_bit_identical(seed):
    geno, member, smask = tiles(seed, 1, 128, 256)
    sim, pres = identity(geno[0], member[0], smask[0], 2000.0)
    mem = member[0] & (np.random.default_rng(seed).random(128) < 0.8)
    want = jg.greedy_group(jnp.asarray(sim), jnp.asarray(pres),
                           jnp.asarray(mem), THR)
    got = tg.greedy_group(torch.from_numpy(sim), torch.from_numpy(pres),
                          torch.from_numpy(mem), THR)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    w_j, n_j = jg.rep_weights(want, jnp.asarray(mem))
    w_t, n_t = tg.rep_weights(got, torch.from_numpy(mem))
    np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))
    assert float(n_t) == float(n_j)


@pytest.mark.parametrize("seed,length", [(3, 2000.0), (4, 100.0)])
def test_pi_grouped_matches_jax(seed, length):
    geno, member, smask = tiles(seed, 1, 96, 200)
    sim, pres = identity(geno[0], member[0], smask[0], length)
    want = j_pi_grouped(jnp.asarray(sim), jnp.asarray(pres),
                        jnp.asarray(member[0]), THR)
    got = pi_grouped(torch.from_numpy(sim), torch.from_numpy(pres),
                     torch.from_numpy(member[0]), THR)
    for f in ("n", "num_groups", "pairs_used", "pairs_missing"):
        assert int(getattr(got, f)) == int(getattr(want, f)), f
    assert int(got.num_groups) > 1
    np.testing.assert_allclose(float(got.pi), float(want.pi), rtol=1e-5)


def test_batch_tajd_matches_jax():
    """W = 3 windows (one of S = 2048) by P = 2 overlapping panels."""
    geno, member, smask = tiles(5, 3, 64, 2048)
    smask[1, 300:] = False
    rng = np.random.default_rng(5)
    panels = rng.random((3, 2, 64)) < 0.6
    lengths = np.array([200_000.0, 30_000.0, 0.0], np.float32)
    want = j_batch_tajd(jnp.asarray(geno), jnp.asarray(member),
                        jnp.asarray(smask), jnp.asarray(panels), lengths, THR)
    got = batch_tajd_from_alleles(
        *(torch.from_numpy(a) for a in (geno, member, smask, panels)),
        lengths, THR)
    np.testing.assert_array_equal(got.s.numpy(), np.asarray(want.s))
    np.testing.assert_array_equal(got.n.numpy(), np.asarray(want.n))
    np.testing.assert_allclose(got.pi.numpy(), np.asarray(want.pi),
                               rtol=1e-5, atol=0)
    np.testing.assert_allclose(got.d.numpy(), np.asarray(want.d), rtol=1e-5,
                               atol=1e-6)


# ------------------------------------------------------------- the CLI


def read_table(path):
    lines = [ln.split("\t") for ln in path.read_text().splitlines() if ln]
    return lines[0], lines[1:]


def assert_tables_close(path_a, path_b):
    head_a, rows_a = read_table(path_a)
    head_b, rows_b = read_table(path_b)
    assert head_a == head_b
    assert len(rows_a) == len(rows_b) > 0
    for ra, rb in zip(rows_a, rows_b):
        assert ra[:4] == rb[:4]
        for col, va, vb in zip(head_a[4:], ra[4:], rb[4:]):
            assert (va == "NA") == (vb == "NA"), (col, ra[0])
            if va != "NA":
                np.testing.assert_allclose(float(va), float(vb), rtol=1e-5,
                                           atol=1e-8, err_msg=col)


@pytest.fixture(scope="module")
def geno_dir(tmp_path_factory):
    """Three windows as .npz tiles, names unsorted; the first holds 2100
    sites (S >= 2048, the long-window regime), one window is missing."""
    tmp = tmp_path_factory.mktemp("torch_tajd")
    gdir = tmp / "geno"
    gdir.mkdir()
    rng = np.random.default_rng(9)
    spans = [(0, 100_000, 2100), (100_000, 160_000, 300),
             (160_000, 200_000, 90)]
    for lo, hi, s in spans:
        n = 40
        geno, _, _ = tiles(lo + s, 1, n, s)
        geno = geno[0]
        geno[-5:] = rng.integers(0, 2, size=(5, s))
        names = np.array([f"h{i:02d}#{1 + i % 2}#c" for i in
                          rng.permutation(n)])
        np.savez(gdir / f"chr1:{lo}-{hi}.npz", geno=geno, names=names)
    (tmp / "w.bed").write_text("".join(f"chr1\t{lo}\t{hi}\n"
                                       for lo, hi, _ in spans)
                               + "chr1\t200000\t210000\n")
    (tmp / "sub.txt").write_text("\n".join(f"h{i:02d}" for i in range(15))
                                 + "\n")
    return tmp


@pytest.mark.parametrize("extra", [[], ["-s", "sub.txt"], ["-l", "1000"]])
def test_tajd_geno_dir_matches_jax(geno_dir, tmp_path, extra):
    extra = [str(geno_dir / x) if x.endswith(".txt") else x for x in extra]
    argv = ["tajd", "-b", str(geno_dir / "w.bed"), "-P", "",
            "--geno-dir", str(geno_dir / "geno"), *extra]
    out_j, out_t = tmp_path / "j.tsv", tmp_path / "t.tsv"
    assert jax_main(argv + ["-o", str(out_j)]) == 0
    assert torch_main(argv + ["-o", str(out_t), "--device", "cpu"]) == 0
    assert_tables_close(out_j, out_t)
    rows = read_table(out_t)[1]
    assert len(rows) == 3
    assert int(rows[0][3]) > 1000


def test_tajd_log_dir_matches_jax(geno_dir, tmp_path):
    argv = ["tajd", "-b", str(geno_dir / "w.bed"), "-P", "",
            "--geno-dir", str(geno_dir / "geno")]
    logs = {}
    for name, main, more in (("jax", jax_main, []),
                             ("torch", torch_main, ["--device", "cpu"])):
        d = tmp_path / name
        assert main(argv + ["-o", str(tmp_path / f"{name}.tsv"),
                            "--log-dir", str(d)] + more) == 0
        logs[name] = {p.name: p.read_text() for p in sorted(d.iterdir())}
    assert sorted(logs["jax"]) == sorted(logs["torch"])
    assert len(logs["jax"]) == 3
    for fname, text in logs["jax"].items():
        assert text.splitlines()[0] == logs["torch"][fname].splitlines()[0]
        keys_j = [ln.split(":")[0] for ln in text.splitlines()]
        keys_t = [ln.split(":")[0]
                  for ln in logs["torch"][fname].splitlines()]
        assert keys_j == keys_t


def test_tajd_gfa_dir_matches_jax(tmp_path):
    from impop_tpu.extract import WindowMatrix
    from impop_tpu.extract.gfa import window_to_gfa

    rng = np.random.default_rng(2)
    n, s, start = 12, 30, 100
    ref_seq = "".join(rng.choice(list("ACGT"), size=200))
    pos = np.sort(rng.choice(np.arange(start, start + 200), s,
                             replace=False))
    keys = [f"{p}:{ref_seq[p - start]}>{'T' if ref_seq[p - start] != 'T' else 'A'}"
            for p in pos]
    cls = rng.integers(0, 2, size=(3, s)).astype(np.int8)
    geno = cls[rng.integers(0, 3, size=n)]
    names = [f"HG{i:02d}#1#c{i}:0-200" for i in range(n)]
    wm = WindowMatrix(names, keys, pos.astype(np.int64), geno)
    ref_name = "CHM13#0#chr9"
    fdir = tmp_path / "gfa"
    fdir.mkdir()
    (fdir / f"{ref_name}:{start}-{start + 200}.gfa").write_text(
        window_to_gfa(wm, ref_seq, start, ref_name))
    (tmp_path / "w.bed").write_text(f"chr9\t{start}\t{start + 200}\n")
    argv = ["tajd", "-b", str(tmp_path / "w.bed"), "--gfa-dir", str(fdir)]
    out_j, out_t = tmp_path / "j.tsv", tmp_path / "t.tsv"
    assert jax_main(argv + ["-o", str(out_j)]) == 0
    assert torch_main(argv + ["-o", str(out_t), "--device", "cpu"]) == 0
    assert_tables_close(out_j, out_t)
    assert int(read_table(out_t)[1][0][2]) == n + 1   # + the reference row


@pytest.mark.parametrize("with_subset", [False, True])
def test_tajd_stream_npy_matches_batched_and_jax(geno_dir, tmp_path,
                                                 with_subset):
    """--stream-npy reproduces the batched row of the port exactly, and the
    JAX streamed row within the table tolerance."""
    region = "chr1:0-100000"
    data = np.load(geno_dir / "geno" / f"{region}.npz")
    npy = tmp_path / "w.npy"
    np.save(npy, data["geno"])
    names = tmp_path / "w.names"
    names.write_text("\n".join(str(x) for x in data["names"]) + "\n")
    (tmp_path / "one.bed").write_text("chr1\t0\t100000\n")
    gdir = tmp_path / "geno"
    gdir.mkdir()
    np.savez(gdir / f"{region}.npz", geno=data["geno"], names=data["names"])
    sub = ["-s", str(geno_dir / "sub.txt")] if with_subset else []
    base = ["tajd", "-b", str(tmp_path / "one.bed"), "-P", "", *sub]
    stream = ["--stream-npy", str(npy), "--stream-names", str(names),
              "--chunk-sites", "512"]
    out_b, out_s, out_j = (tmp_path / f"{k}.tsv" for k in "bsj")
    assert torch_main(base + ["--geno-dir", str(gdir), "-o", str(out_b),
                              "--device", "cpu"]) == 0
    assert torch_main(base + stream + ["-o", str(out_s),
                                       "--device", "cpu"]) == 0
    assert jax_main(base + stream + ["-o", str(out_j)]) == 0
    assert out_b.read_text() == out_s.read_text()
    assert_tables_close(out_j, out_s)
    row = read_table(out_s)[1][0]
    assert int(row[2]) == (15 if with_subset else 40)


def test_tajd_stream_log_and_errors(geno_dir, tmp_path):
    npy = tmp_path / "w.npy"
    np.save(npy, np.load(geno_dir / "geno" / "chr1:0-100000.npz")["geno"])
    (tmp_path / "one.bed").write_text("chr1\t0\t100000\n")
    logd = tmp_path / "logs"
    assert torch_main(["tajd", "-b", str(tmp_path / "one.bed"), "-P", "",
                       "--stream-npy", str(npy), "--chunk-sites", "1000",
                       "-o", str(tmp_path / "t.tsv"), "--log-dir", str(logd),
                       "--device", "cpu"]) == 0
    text = next(logd.iterdir()).read_text()
    assert "site_chunks: 3" in text
    with pytest.raises(SystemExit, match="exactly one window"):
        torch_main(["tajd", "-b", str(geno_dir / "w.bed"), "--stream-npy",
                    str(npy), "--device", "cpu"])
    with pytest.raises(SystemExit, match="--stream-names"):
        torch_main(["tajd", "-b", str(tmp_path / "one.bed"), "--stream-npy",
                    str(npy), "-s", str(geno_dir / "sub.txt"),
                    "--device", "cpu"])


def test_tajd_refuses_cuda_without_a_card(geno_dir):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        torch_main(["tajd", "-b", str(geno_dir / "w.bed"), "-P", "",
                    "--geno-dir", str(geno_dir / "geno")])
