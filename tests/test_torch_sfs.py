"""The port's ``sfs`` against ``impop_tpu.cli sfs`` on the same allele
tiles: the merged table and the ``--per-window`` file byte-identical,
without and with panels, folded and ``--unfolded``, with and without
``--max-n``, and with the windows in device batches forced small (one,
two and all windows a batch)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import impop_tpu_torch.cli as torch_cli
from impop_tpu.cli import main as jax_main
from impop_tpu_torch.cli import main as torch_main
from impop_tpu_torch.hostio import simulate

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiles(tmp_path_factory):
    """Three 2 kb windows (one missing from the tile directory) and two
    panel files."""
    tmp = tmp_path_factory.mktemp("sfs")
    sim = simulate(str(tmp), ref_len=6000, n_haps=14, n_snps=24, seed=19,
                   span=(0, 6000))
    bed = tmp / "w.bed"
    bed.write_text("chr1\t0\t2000\nchr1\t2000\t4000\nchr1\t4000\t6000\n"
                   "chr1\t6000\t8000\n")
    tdir = tmp / "tiles"
    assert torch_main(["extract", "-b", str(bed), "--paf", sim.paf_path,
                       "--fasta", sim.fasta_path, "--out-dir", str(tdir),
                       "-P", "CHM13#0#"]) == 0
    names = sorted({str(n) for f in tdir.glob("*.npz")
                    for n in np.load(f)["names"]})
    haps = ["{}_hap{}".format(*n.split("#")[:2]) for n in names
            if not n.startswith("CHM13")]
    panels = []
    for label, part in (("panA", haps[:6]), ("panB", haps[4:])):
        path = tmp / label
        path.write_text("\n".join(part) + "\n")
        panels += ["--panel", str(path)]
    return tmp, str(bed), str(tdir), panels


CASES = [("all", []), ("unfolded", ["--unfolded"]),
         ("max_n", ["--max-n", "6"]),
         ("unfolded_max_n", ["--unfolded", "--max-n", "40"])]


@pytest.mark.parametrize("with_panels", [False, True])
@pytest.mark.parametrize("tag,flags", CASES)
def test_sfs_files_equal_jax(tiles, with_panels, tag, flags):
    tmp, bed, tdir, panels = tiles
    argv = ["sfs", "-b", bed, "--geno-dir", tdir, "-P", "CHM13#0#",
            *flags, *(panels if with_panels else [])]
    stem = tmp / f"{tag}_{with_panels}"
    assert jax_main(argv + ["-o", f"{stem}.jax", "--per-window",
                            f"{stem}.jax.pw"]) == 0
    want = (open(f"{stem}.jax").read(), open(f"{stem}.jax.pw").read())
    assert len(want[0].splitlines()) > 2 and len(want[1].splitlines()) > 3
    for per_batch in (1, 2, 3):
        out = f"{stem}.torch{per_batch}"
        elems = torch_cli._WINDOW_CHUNK_ELEMS
        try:
            # cap_n 64, cap_s 128 for these tiles
            torch_cli._WINDOW_CHUNK_ELEMS = (
                per_batch * 64 * 128 * (2 if with_panels else 1))
            assert torch_main(argv + ["-o", out, "--per-window",
                                      out + ".pw", "--device", "cpu"]) == 0
        finally:
            torch_cli._WINDOW_CHUNK_ELEMS = elems
        assert (open(out).read(), open(out + ".pw").read()) == want


def test_sfs_without_windows_prints_the_header(tiles):
    tmp, _, tdir, panels = tiles
    bed = tmp / "none.bed"
    bed.write_text("chr2\t0\t100\n")
    argv = ["sfs", "-b", str(bed), "--geno-dir", tdir, *panels]
    assert jax_main(argv + ["-o", str(tmp / "none.jax")]) == 0
    assert torch_main(argv + ["-o", str(tmp / "none.torch"),
                              "--device", "cpu"]) == 0
    assert (tmp / "none.torch").read_text() == \
        (tmp / "none.jax").read_text() == "ALLELE_COUNT\tSITES_panA\tSITES_panB\n"


def test_expand_population_bisect_equals_jax():
    """The port's binary-search ``expand_population`` (used by ``sfs``,
    ``tajd``, ``scan`` and the batcher) against the JAX package's
    all-names loop on names with coordinates, duplicates, bare samples
    (both haplotypes), ``_hprc`` suffixes, ``#`` ids and ids that match
    nothing: the same matched set and the same missing ids in order."""
    from impop_tpu.io.panels import expand_population as j_expand
    from impop_tpu_torch.io.panels import expand_population

    rng = np.random.default_rng(4)
    samples = [f"HG{k:05d}" for k in range(0, 60, 3)] + ["NA1", "NA12"]
    names = [f"{s}#{h}#ctg{rng.integers(9)}:{rng.integers(1000)}-2000"
             for s in samples for h in (1, 2)]
    names += [names[5], "CHM13#0#chr1:0-5000"]
    names = [names[k] for k in rng.permutation(len(names))]
    panels = [["HG00000_hap1", "HG00003", "NA1", "HG00006_hap2_hprc_r2"],
              ["HG00009#2", "HG99999_hap1", "", "# comment", "NA12_mat"],
              ["CHM13#0#chr1", "HG00012_pat", "HG00012_hap2", "NA"]]
    for plist in panels:
        got = expand_population(plist, iter(names))
        assert got == j_expand(plist, names), plist
        assert got[0]
