"""The port's benchmark, the twin of the repository's ``bench.py``:
200 kb-windows per second on one card for the full π + Fst + Tajima's D
panel workload, in bench.py's regimes and with its keys.

    python -m impop_tpu_torch.bench [--device cuda|cpu] [--batch W]
        [--iters K] [--e2e-batch W] [--e2e-mb MB] [--long-shape N S W]
        [--ehh-batch W] [--baseline-windows K] [--baseline-passes P]

1. ``value``: the device step on resident HPRC-shaped tiles
   (``inputs.hprc_batch``, 466 haplotypes at [512, 128], 5 panels, 10
   disjoint pairs): ``fused_window_stats(return_matrices=False)`` (the
   window kernel), Tajima's D and 3-π Fst, ``--iters`` back-to-back calls
   ended by a fetch to the host.  One 200 kb unit is 40 windows of 5 kb.
2. ``vs_baseline``: the same statistics through the pure-Python
   estimators of ``bench/oracle.py`` on windows of regime 1, best of
   ``--baseline-passes`` passes, as a ratio of rates.
3. ``long_window``: identity (``unit_gram_kernel``, int8 ``wgmma``) + S
   on [512, 8192] x 64, with its rate against the H100 int8 peak.
4. ``ehh``: ``ehh_area_batch`` (the EHH kernel) at [512, 128] x 64.
5. ``ehh_fused``: regime 1's statistics plus ``ehh_area_dynamic`` at a
   focal of each window, ``--e2e-batch`` windows.
6. ``e2e``: ``scan`` through ``cli.main`` on a simulated pangenome of
   ``--e2e-mb`` megabases, one cold run and three warm ones.

Sizes default to bench.py's and to its environment variables
(``IMPOP_BENCH_BATCH``, ``IMPOP_BENCH_ITERS``, ``IMPOP_BENCH_E2E_BATCH``,
``IMPOP_BENCH_E2E_MB``); the flags override them.  The kernels are built
(nvcc) before the first regime and each regime calls its step once before
timing it, so no regime times a build.  A regime that fails ends the run
with its exception.  Prints one JSON line: bench.py's keys and
``device`` (the card's name and power limit).
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from impop_tpu_torch.bench import inputs, oracle
from impop_tpu_torch.bench.inputs import (CAP_N, CAP_S, N_HAP, PANEL_SIZES,
                                          THRESHOLD, WIN_BP)

__all__ = ["main", "device_step", "ehh_fused_step", "long_window_step"]

UNIT_WINDOWS = 40
PAIRS = [(a, b) for i, a in enumerate(PANEL_SIZES)
         for b in list(PANEL_SIZES)[i + 1:]]
PAIR_A = tuple(list(PANEL_SIZES).index(a) for a, _ in PAIRS)
PAIR_B = tuple(list(PANEL_SIZES).index(b) for _, b in PAIRS)
LONG_BP = 500_000.0


def parse_args(argv):
    env = os.environ.get
    ap = argparse.ArgumentParser(prog="python -m impop_tpu_torch.bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:K or cpu")
    ap.add_argument("--batch", type=int,
                    default=int(env("IMPOP_BENCH_BATCH", 2240)),
                    help="windows of the device step (IMPOP_BENCH_BATCH)")
    ap.add_argument("--iters", type=int,
                    default=int(env("IMPOP_BENCH_ITERS", 32)),
                    help="timed calls of the device step; the long window "
                         "takes half, at least 2 (IMPOP_BENCH_ITERS)")
    ap.add_argument("--e2e-batch", type=int,
                    default=int(env("IMPOP_BENCH_E2E_BATCH", 320)),
                    help="scan --batch of the e2e regime, and the windows "
                         "of ehh_fused (IMPOP_BENCH_E2E_BATCH)")
    ap.add_argument("--e2e-mb", type=float,
                    default=float(env("IMPOP_BENCH_E2E_MB", 10)),
                    help="megabases of the simulated pangenome "
                         "(IMPOP_BENCH_E2E_MB)")
    ap.add_argument("--long-shape", type=int, nargs=3,
                    default=(512, 8192, 64), metavar=("N", "S", "W"),
                    help="long_window's [N, S] x W")
    ap.add_argument("--ehh-batch", type=int, default=64,
                    help="windows of the ehh regime")
    ap.add_argument("--baseline-windows", type=int, default=10,
                    help="windows of each vs_baseline pass")
    ap.add_argument("--baseline-passes", type=int, default=3)
    return ap.parse_args(argv)


def fetch(out):
    """The first output copied to the host: the barrier of a timed run
    (the copy waits for the device)."""
    first = out[0] if isinstance(out, tuple) else out
    return first.cpu()


def timed(step, args, iters):
    """(seconds of ``iters`` back-to-back calls of step(*args) ended by a
    fetch, last output), after one call that is not timed."""
    fetch(step(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = step(*args)
    fetch(out)
    return time.perf_counter() - t0, out


def device_step(geno, member, smask, panels, lengths):
    """bench.py's ``device_pipeline`` step over a batch of windows:
    (π / length [W, P], D [W, P], Fst [W, Q], grouped Fst [W, Q], 3-π Fst
    [W, Q], S [W]); the panels of each pair are disjoint."""
    import torch

    from impop_tpu_torch.stats.panelstats import fused_window_stats, take
    from impop_tpu_torch.stats.tajima import tajimas_d

    _sim, _present, s_count, res = fused_window_stats(
        geno, member, smask, lengths, panels, PAIR_A, PAIR_B, THRESHOLD,
        pairs_disjoint=True, return_matrices=False)
    p_count = panels.shape[-2]
    pi_panel = res.pi[..., :p_count]
    pi_c = res.pi[..., p_count:]
    per_bp = pi_panel / lengths[..., None]
    d = tajimas_d(res.n[..., :p_count], s_count[..., None], per_bp)
    pi_ab = 0.5 * (take(pi_panel, PAIR_A, -1) + take(pi_panel, PAIR_B, -1))
    f3 = torch.where(pi_c != 0,
                     (pi_c - pi_ab) / torch.where(pi_c != 0, pi_c, 1.0),
                     torch.nan)
    return per_bp, d, res.hudson.fst, res.hudson_grouped.fst, f3, s_count


def ehh_fused_step(geno, member, smask, panels, lengths, focals):
    """bench.py's ``bench_ehh_fused`` step: per window the row [π (P+Q),
    Fst (Q), grouped Fst (Q), EHH area (alleles 0, 1), carriers (0, 1),
    S], float32."""
    import torch

    from impop_tpu_torch.stats.ehh import ehh_area_dynamic
    from impop_tpu_torch.stats.panelstats import fused_window_stats

    _s, _p, s_count, res = fused_window_stats(
        geno, member, smask, lengths, panels, PAIR_A, PAIR_B, THRESHOLD,
        pairs_disjoint=True, return_matrices=False)
    area, carr = ehh_area_dynamic(geno, member, smask, focals)
    return torch.cat([res.pi, res.hudson.fst, res.hudson_grouped.fst, area,
                      carr.to(torch.float32), s_count[..., None]], dim=-1)


def long_window_step(geno, member, smask):
    """(sum of sim [W], S [W]) of long windows, ``LONG_BP`` bp each."""
    from impop_tpu_torch.stats.allele import (identity_from_alleles,
                                              segregating_sites)

    sim, _present = identity_from_alleles(geno, member, smask, LONG_BP)
    return sim.sum(dim=(-2, -1)), segregating_sites(geno, member, smask)


def long_inputs(n, s, wbatch):
    """bench.py's long-window tiles (seed 7): 16 classes over every site,
    0.1% noise, rows past the 466 haplotypes padding."""
    rng = np.random.default_rng(7)
    classes = rng.integers(0, 2, size=(16, s)).astype(np.int8)
    g = classes[rng.integers(0, 16, size=(wbatch, n))]
    g = np.where(rng.random((wbatch, n, s)) < 0.001, 1 - g, g).astype(np.int8)
    g[:, N_HAP:] = -1
    member = np.zeros((wbatch, n), bool)
    member[:, :N_HAP] = True
    return g, member, np.ones((wbatch, s), bool)


def bench_device(dev, batch, iters):
    """Regime 1: windows per second of the device step on resident
    tensors."""
    args = inputs.to_dev(dev, *batch)
    dt, _ = timed(device_step, args, iters)
    return batch[0].shape[0] * iters / dt


def bench_long_window(dev, iters, n, s, wbatch):
    """Long windows: identity + S on [n, s] x wbatch, as cells and as a
    rate against the H100 int8 peak (the type the identity kernel runs)."""
    from impop_tpu_torch.bench.roofline import H100_PEAK

    args = inputs.to_dev(dev, *long_inputs(n, s, wbatch))
    dt, _ = timed(long_window_step, args, iters)
    per_win = dt / (iters * wbatch)
    gcells = n * n * s / 1e9
    # the rate at the full product's cost, 4 operations a cell (the z/v
    # formulation's two Grams over all N² cells): the kernel computes the
    # upper triangle of tiles only, about 0.625 of those operations, so
    # mfu_pct can exceed the tensor cores' real occupancy
    tflops = gcells * 4.0 / per_win / 1e3
    return {
        "n": n, "s": s, "wbatch": wbatch,
        "windows_per_sec": iters * wbatch / dt,
        "gcells_per_sec": gcells / per_win,
        "tflops": tflops,
        "peak": "int8",
        "mfu_pct": (100.0 * tflops * 1e12 / H100_PEAK["int8"]
                    if dev.type == "cuda" else None),
    }


def bench_ehh(dev, w, iters=8, n=CAP_N, s=CAP_S):
    """EHH areas of both alleles at the middle column of every window."""
    from impop_tpu_torch.stats.ehh import ehh_area_batch

    rng = np.random.default_rng(13)
    classes = rng.integers(0, 2, size=(8, s)).astype(np.int8)
    g = classes[rng.integers(0, 8, size=(w, n))]
    member = np.zeros((w, n), bool)
    member[:, :N_HAP] = True
    args = inputs.to_dev(dev, g, member, np.ones((w, s), bool))
    dt, _ = timed(lambda *a: ehh_area_batch(*a, s // 2, (0, 1)), args,
                  iters)
    return {"windows_per_sec": w * iters / dt,
            "units_per_sec": w * iters / dt / UNIT_WINDOWS}


def bench_ehh_fused(dev, w, iters=8):
    """Regime 1's statistics plus EHH areas at a focal column of each
    window (one of its first 20, always active)."""
    rng = np.random.default_rng(17)
    batch = inputs.hprc_batch(rng, w)
    focals = rng.integers(0, 20, size=w).astype(np.int32)
    args = inputs.to_dev(dev, *batch, focals)
    dt, _ = timed(ehh_fused_step, args, iters)
    return {"windows_per_sec": w * iters / dt,
            "units_per_sec": w * iters / dt / UNIT_WINDOWS}


def bench_e2e_scan(device, e2e_batch, e2e_mb, nvcc_sec):
    """``scan`` end to end on a simulated PAF + FASTA pangenome (466
    haplotypes, 5 kb windows): extraction, packing, H2D, device, fetch,
    emit.  One cold run (the first scan of this process) and three warm
    ones, the best warm run's full wall reported.

    The port compiles nothing at run time, but builds its two native
    libraries at first use: the kernels (nvcc, before regime 1) and the
    extractor (g++, here before the cold run).  ``compile_sec_cold`` is
    the sum of the two builds' seconds in this process (a library already
    built on disk only loads), ``build_sec`` each; neither is inside a
    scan's wall.  ``stages_sec`` is the best warm run's stage breakdown,
    ``stages_sec_cold`` the cold run's."""
    from impop_tpu_torch import cli
    from impop_tpu_torch.extract import load_library
    from impop_tpu_torch.extract.simulate import simulate

    tmp = tempfile.mkdtemp(prefix="impop_bench_")
    try:
        ref_len = int(e2e_mb * 1_000_000)
        sim = simulate(tmp, ref_len=ref_len, n_haps=N_HAP - 1,
                       site_pool=ref_len // 60, seed=11, span=(0, ref_len))
        bed = os.path.join(tmp, "w.bed")
        with open(bed, "w") as fh:
            for lo in range(0, ref_len, WIN_BP):
                fh.write(f"chr1\t{lo}\t{lo + WIN_BP}\n")
        # panels as SAMPLE_hapN entries, the reference's panel lists
        ents = [f"{h.name.split('#')[0]}_hap{h.name.split('#')[1]}"
                for h in sim.haplotypes]
        panel_args = []
        start = 0
        for pname, size in PANEL_SIZES.items():
            pfile = os.path.join(tmp, f"agc.{pname}")
            with open(pfile, "w") as fh:
                fh.write("\n".join(ents[start:start + size]) + "\n")
            start += size
            panel_args += ["--panel", pfile]
        # write back the simulator's dirty pages before the timed scans
        os.sync()
        t0 = time.perf_counter()
        load_library()
        gxx_sec = time.perf_counter() - t0

        def run(tag):
            timing = os.path.join(tmp, f"timing_{tag}.json")
            rc = cli.main(["scan", "-b", bed, "--paf", sim.paf_path,
                           "--fasta", sim.fasta_path, "-P", "CHM13#0#",
                           "-o", os.path.join(tmp, f"out_{tag}.tsv"),
                           "--batch", str(e2e_batch), "--timing-json",
                           timing, "--device", device] + panel_args)
            if rc:
                raise RuntimeError(f"e2e: scan {tag} exited {rc}")
            with open(timing) as fh:
                return json.load(fh)

        cold = run("cold")
        warm = min((run(f"warm{k}") for k in (1, 2, 3)),
                   key=lambda t: t["elapsed_sec"])
        windows = warm["windows"]
        return {
            "windows": windows,
            "units_per_sec": windows / UNIT_WINDOWS / warm["elapsed_sec"],
            "units_per_sec_cold": (cold["windows"] / UNIT_WINDOWS
                                   / cold["elapsed_sec"]),
            "compile_sec_cold": nvcc_sec + gxx_sec,
            "build_sec": {"nvcc": nvcc_sec, "gxx": gxx_sec},
            "stages_sec": {k: v["total_sec"]
                           for k, v in warm["stages"].items()},
            "stages_sec_cold": {k: v["total_sec"]
                                for k, v in cold["stages"].items()},
        }
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def python_reference_rate(batch, n_windows):
    """Windows per second of the pure-Python estimators on the first
    ``n_windows`` windows of ``batch``: the identity by numpy, then π and
    D per panel, direct and grouped Hudson Fst and the union π per pair.
    Each panel's name set is built once (bench.py builds it again for
    every entry of the dict it filters, which times set construction,
    not the estimators)."""
    geno, member, site_mask, panels, _lengths = batch
    names_of = list(PANEL_SIZES)
    times = []
    for wi in range(n_windows):
        g = geno[wi][member[wi]][:, site_mask[wi]]
        n = g.shape[0]
        names = [f"h{i:04d}" for i in range(n)]
        t0 = time.perf_counter()
        diff = (g[:, None, :] != g[None, :, :]).sum(-1)
        sim_mat = 1.0 - diff / WIN_BP
        sim_dict = {(names[i], names[j]): float(sim_mat[i, j])
                    for i in range(n) for j in range(i + 1, n)}
        s_count = int((g.max(0) != g.min(0)).sum())

        def sub_dict(keep):
            return {k: v for k, v in sim_dict.items()
                    if k[0] in keep and k[1] in keep}

        members = []
        for pi_idx in range(len(names_of)):
            mask = panels[wi, pi_idx][member[wi]]
            members.append([names[i] for i in range(n) if mask[i]])
        for sub in members:
            pval, _ = oracle.pica2_pi(sub_dict(set(sub)), sub, THRESHOLD)
            oracle.tajimas_d(len(sub), float(s_count), pval / WIN_BP)
        for a, b in PAIRS:
            pa, pb = members[names_of.index(a)], members[names_of.index(b)]
            oracle.hudson_fst_direct(sim_dict, pa, pb)
            oracle.hudson_fst_grouped(sim_dict, pa, pb, THRESHOLD)
            union = sorted(set(pa) | set(pb))
            oracle.pica2_pi(sub_dict(set(union)), union, THRESHOLD)
        times.append(time.perf_counter() - t0)
    return 1.0 / float(np.mean(times))


def device_info(dev) -> dict:
    """The device's name and power limit (nvidia-smi's line on CUDA)."""
    if dev.type != "cuda":
        return {"type": "cpu", "name": "cpu", "power_limit": None}
    from impop_tpu_torch.bench.roofline import nvidia_smi_line

    name, _, limit = nvidia_smi_line().partition(", ")
    return {"type": "cuda", "name": name, "power_limit": limit}


def main(argv=None) -> int:
    from impop_tpu_torch.device import resolve_device

    args = parse_args(argv)
    dev = resolve_device(args.device)
    nvcc_sec = 0.0
    if dev.type == "cuda":
        from impop_tpu_torch.ops._build import load_library

        t0 = time.perf_counter()
        load_library()
        nvcc_sec = time.perf_counter() - t0
    info = device_info(dev)

    batch = inputs.hprc_batch(np.random.default_rng(42), args.batch)
    windows_per_sec = bench_device(dev, batch, args.iters)
    rates = [python_reference_rate(batch, args.baseline_windows)
             for _ in range(args.baseline_passes)]
    vs_detail = {
        "windows": args.baseline_windows, "best_of": args.baseline_passes,
        "spread_pct": 100.0 * (max(rates) - min(rates)) / max(rates),
        "py_windows_per_sec": rates,
    }
    n, s, wbatch = args.long_shape
    long_window = bench_long_window(dev, max(args.iters // 2, 2), n, s,
                                    wbatch)
    ehh = bench_ehh(dev, args.ehh_batch)
    ehh_fused = bench_ehh_fused(dev, args.e2e_batch)
    e2e = bench_e2e_scan(args.device, args.e2e_batch, args.e2e_mb,
                         nvcc_sec)
    print(json.dumps({
        "metric": "200kb-windows/sec/chip for pi+Fst(direct+grouped)+TajD",
        "value": windows_per_sec / UNIT_WINDOWS,
        "unit": "200kb-units/sec/chip",
        "vs_baseline": windows_per_sec / max(rates),
        "vs_baseline_detail": vs_detail,
        "e2e": e2e,
        "long_window": long_window,
        "ehh": ehh,
        "ehh_fused": ehh_fused,
        "device": info,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
