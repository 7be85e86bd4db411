"""Multi-host and pair-space commands of the port on the CPU.

- A real two-process ``python -m impop_tpu_torch.cli scan --distributed
  --device cpu``: two processes join a gloo group at a local port through
  torchrun's variables (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``), each scans its contiguous share of the
  windows (``parallel.distributed.host_window_range``) into ``.partK``
  outputs, and ``merge-parts`` / ``merge-parts --sum`` join them: the
  table and the spectrum must equal the one-process port scan byte for
  byte, and the JAX package's scan of the same tiles (integers exact,
  π / D rtol 1e-5, Fst atol 2e-3; spectrum files identical), as
  ``tests/test_distributed.py`` checks the JAX one.  Each process also
  shows that ``jax`` and ``impop_tpu`` stay out of its ``sys.modules``.
- ``hfst`` / ``hud -m direct --pair-shard on --device cpu`` against
  ``--pair-shard off`` of the port and against the JAX command with
  ``--pair-shard on`` (tables within ``test_torch_stats_cli``'s budget),
  with ``-r`` giving the JAX warning; and in device batches of two
  windows, one call a batch.
"""
from __future__ import annotations

import pytest
import torch

from impop_tpu.cli import main as jax_main
from impop_tpu_torch.cli import main as torch_main
from impop_tpu_torch.hostio import simulate
from impop_tpu_torch.parallel.distributed import maybe_initialize
from test_torch_cli import assert_tables_close as assert_scan_tables_close
from test_torch_imports import run_ranks
from test_torch_stats_cli import assert_tables_close

torch.set_num_threads(1)
N_WINDOWS = 5


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_dist")
    span = 1000 * N_WINDOWS
    sim = simulate(str(tmp), ref_len=span, n_haps=8, n_snps=12, seed=29,
                   span=(0, span))
    bed = tmp / "w.bed"
    bed.write_text("".join(f"chr1\t{i * 1000}\t{(i + 1) * 1000}\n"
                           for i in range(N_WINDOWS)))
    (tmp / "agc.A").write_text("HG00900\nHG00901\n")
    (tmp / "agc.B").write_text("HG00902\nHG00903\n")
    tiles = tmp / "tiles"
    assert torch_main(["extract", "-b", str(bed), "--paf", sim.paf_path,
                       "--fasta", sim.fasta_path, "--out-dir", str(tiles),
                       "-P", "CHM13#0#", "--python"]) == 0
    return tmp, bed, tiles


def scan_argv(tmp, bed, tiles, out, afs):
    return ["scan", "-b", str(bed), "--geno-dir", str(tiles), "-P",
            "CHM13#0#", "--panel", str(tmp / "agc.A"), "--panel",
            str(tmp / "agc.B"), "-o", str(out), "--afs", str(afs)]


def test_two_process_scan_and_merge(dataset, tmp_path):
    tmp, bed, tiles = dataset
    single = tmp_path / "single.tsv"
    assert torch_main(scan_argv(tmp, bed, tiles, single,
                                tmp_path / "single.afs")
                      + ["--device", "cpu"]) == 0
    assert jax_main(scan_argv(tmp, bed, tiles, tmp_path / "jax.tsv",
                              tmp_path / "jax.afs")) == 0

    out = tmp_path / "dist.tsv"
    run_ranks(scan_argv(tmp, bed, tiles, out, tmp_path / "dist.afs")
              + ["--device", "cpu", "--distributed"])
    parts = [(out.parent / f"{out.name}.part{k}") for k in range(2)]
    # rank 0 takes windows 0-2, rank 1 windows 3-4 (host_window_range)
    assert [len(p.read_text().splitlines()) - 1 for p in parts] == [3, 2]
    assert torch_main(["merge-parts", str(out)]) == 0
    assert out.read_text() == single.read_text()
    assert torch_main(["merge-parts", str(tmp_path / "dist.afs"),
                       "--sum"]) == 0
    assert ((tmp_path / "dist.afs").read_bytes()
            == (tmp_path / "single.afs").read_bytes())
    # and the JAX package's scan of the same tiles
    assert_scan_tables_close(tmp_path / "jax.tsv", out)
    assert ((tmp_path / "jax.afs").read_bytes()
            == (tmp_path / "dist.afs").read_bytes())


def test_initialize_needs_the_group_environment(monkeypatch):
    assert maybe_initialize(False) == (0, 1)
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    with pytest.raises(SystemExit, match="MASTER_PORT, RANK, WORLD_SIZE"):
        maybe_initialize(True)


def hudson_argv(cmd, tmp, bed, tiles, out):
    return cmd + ["-b", str(bed), "--geno-dir", str(tiles), "-P",
                  "CHM13#0#", "-A", str(tmp / "agc.A"), "-B",
                  str(tmp / "agc.B"), "-o", str(out)]


@pytest.mark.parametrize("cmd", [["hfst"], ["hud", "-m", "direct"]])
def test_pair_shard_on_matches_off_and_jax(dataset, tmp_path, cmd, capsys):
    tmp, bed, tiles = dataset
    paths = {}
    for tag, main, extra in (
            ("on", torch_main, ["--pair-shard", "on", "--device", "cpu"]),
            ("off", torch_main, ["--pair-shard", "off", "--device", "cpu"]),
            ("jax", jax_main, ["--pair-shard", "on"])):
        paths[tag] = tmp_path / f"{tag}.tsv"
        assert main(hudson_argv(cmd, tmp, bed, tiles, paths[tag])
                    + extra) == 0
    rows = assert_tables_close(paths["on"], paths["off"])
    assert len(rows) == N_WINDOWS + 1
    assert_tables_close(paths["on"], paths["jax"])
    capsys.readouterr()
    assert torch_main(hudson_argv(cmd, tmp, bed, tiles, tmp_path / "r.tsv")
                      + ["--pair-shard", "on", "-r", "5",
                         "--device", "cpu"]) == 0
    assert "-r rounding does not apply" in capsys.readouterr().err


def test_pair_shard_runs_device_batches(dataset, tmp_path, monkeypatch):
    """With the batch budget shrunk to two windows, ``hfst --pair-shard
    on`` makes one call (and one host read) for each of three device
    batches; its table equals ``--pair-shard off`` within the budget and
    the one-batch run's."""
    import impop_tpu_torch.cli as cli_mod
    import impop_tpu_torch.parallel.pairspace as pair_mod
    from impop_tpu_torch.hostio import _capacity_for

    tmp, bed, tiles = dataset
    one_batch = tmp_path / "one.tsv"
    assert torch_main(hudson_argv(["hfst"], tmp, bed, tiles, one_batch)
                      + ["--pair-shard", "on", "--device", "cpu"]) == 0
    # 8 haplotypes on one device: a window's int8 cells outnumber its
    # pair block, so the budget of two windows is two windows' cells
    monkeypatch.setattr(cli_mod, "_WINDOW_CHUNK_ELEMS",
                        2 * _capacity_for([8]) * 128)
    calls = []
    real = pair_mod.pair_sharded_direct_stats

    def counted(mesh, axis="data"):
        fn = real(mesh, axis)

        def call(geno, *args):
            calls.append(geno.shape[0])
            return fn(geno, *args)
        return call

    monkeypatch.setattr(pair_mod, "pair_sharded_direct_stats", counted)
    paths = {}
    for mode in ("on", "off"):
        paths[mode] = tmp_path / f"{mode}.tsv"
        assert torch_main(hudson_argv(["hfst"], tmp, bed, tiles,
                                      paths[mode])
                          + ["--pair-shard", mode, "--device", "cpu"]) == 0
    assert calls == [2, 2, 1]
    rows = assert_tables_close(paths["on"], paths["off"])
    assert len(rows) == N_WINDOWS + 1
    assert_tables_close(paths["on"], one_batch)


@pytest.mark.parametrize("name,local_world,want", [
    ("cuda", None, [0, 1]),     # one process per host: every local GPU
    ("cuda", "2", [1]),         # two per host: cuda:LOCAL_RANK
    ("cuda:0", "2", [0])])      # an index is kept
def test_process_devices_follow_the_launcher(monkeypatch, name, local_world,
                                             want):
    import impop_tpu_torch.parallel.distributed as dist_mod

    def two_gpus(dev_name):
        idx = torch.device(dev_name).index
        return ([torch.device("cuda", k) for k in (0, 1)] if idx is None
                else [torch.device(dev_name)])

    monkeypatch.setattr(dist_mod, "local_devices", two_gpus)
    monkeypatch.setenv("LOCAL_RANK", "1")
    if local_world is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local_world)
    assert [d.index for d in dist_mod.process_devices(name)] == want
