#!/usr/bin/env python3
"""Quickest proof that impop_tpu_torch runs its main path on one GPU.

    python3 chip_smoke.py

Phases (one line each; any failure exits non-zero):
  0  identify the machine (device, nvidia-smi name and power limit,
     torch / CUDA / nvcc versions)
  1  build the CUDA kernels from impop_tpu_torch/csrc
  2  each kernel against its plain PyTorch version on the card:
     (a) [512, 128] x 320 HPRC-shaped windows, 5 panels / 10 disjoint
         pairs, with kernel and plain per-window times (CUDA events) and
         the time of each of the window program's kernels (torch.profiler,
         printed after 2j, so that no kernel of phase 2 is timed after a
         profiler session);
     (b) cap 256 with 4 and with 10 overlapping panels, cap 1152; (c) a
     partial-coverage window that sets seed_risk; (d) cap_s = 4096, timed
     and profiled as (a);
     (e) seed_peel: seeds and gid exactly equal to the plain composition
         at [512, 512] x 1 with 20 masks, x 10 with one mask (tajd's step)
         and x 200 with two (phase 9's), each timed with its longest seed
         chain beside its byte bound;
     (f) ehh_area: [512, 128] x 320 with the focal at the middle variant,
         focals on the first and last active site, a window with no
         active site, [512, 4096] x 4 (words read from device memory) and
         [512, 1024] x 16 past 2^24, timed (all exactly equal);
     (g) pairwise_identity_weighted: [512, 128] x 64 with integer weights
         1-50 and a 100 000 bp column, [512, 4096] x 4, and ragged
         [37, 37], [37, 1], [1024, 3120] with weights 1-50 and 100 000 bp
         columns (per-pair sums below 2^24), all-ones
         weights (exactly equal), non-integer weights (present equal, sim
         within 1e-5 of the weight mass per bp + 1e-6);
     (h) masked_pair_sums on the stacks the columns scan builds, disjoint
         and overlapping pairs, with a Wp that is not 0/1 (three bf16
         pieces a Wp row), the drivers' [512, 512] x 128 with 2 + 2 rows,
         N = 4160 (65 column tiles) and 128 / 256 / 150 value rows with 140
         0/1 rows (three, four and three grid layers of two 64-row tiles)
         (0/1 rows of Yp exact, the rest rtol 1e-5), timed by CUDA graph
         replay and with the wrapper (CUDA events) beside its bound, the
         all-fp32 bound, the tensor-core count of the bf16 pieces and two
         fp32 bmm on precomputed operands, the time per value row at three
         layers and at four, profiled by launch after 2j;
     (i) pairwise_identity (unit weights): [512, 2048] x 64, [512, 8192] x 8
         and tajd's [512, 3200] x 10 with kernel, plain and yardstick times
         and a sweep of forced site splits, [1024, 2048] x 4, codes up to 3
         (a member without calls, length 0) and up to 63, ragged [37, 37],
         [37, 1], [1024, 3120] (sim and present exactly equal);
     (j) identity_group: [512, 128] x 320 with R = 15, timed as (h) and
         profiled by launch, cap 256 with overlapping panels, cap 1152,
         [512, 4096] x 8 (present from OR-ed words) (sim, present, gid, S
         exactly equal)
     (k) every kernel on the degenerate batches of
         ``impop_tpu_torch/bench/degenerate.py``: a window with no active
         site, a monomorphic one, one with every row missing and one with
         no member at the first, middle and last window of [512, 128] x 8
         and [1152, 128] x 4, beside an empty and a one-member panel, side
         by side and overlapping (window kernel, identity_group at R = 15);
         the seed peel at [512, 512] x 4 with 20 masks; EHH with no and
         one carrier of the focal allele, monomorphic and memberless
         windows at N = 512, 37 and 1000; the unit and weighted identity
         at N = 512, 1024 (streamed), 37 and 1000, with zero weights on
         every active column; the masked sums with an empty and a one-hot
         row and a window without present pairs, 0/1 and fp32 Wp (83
         batches; integers, seeds, gid, sim and present exact, float sums
         rtol 1e-5, NaN in the same places)
  3  the port's ``scan`` end to end on a simulated 2 Mb, 466-haplotype
     pangenome (400 windows of 5 kb), then the first 20 windows again on
     the CPU, then a journal resume
  4  the seed_risk recompute through ``scan --geno-dir`` on a
     partial-coverage window
  5  ``scan --ehh --afs`` on the same pangenome: GPU against CPU on 20
     windows (EHH areas rtol 1e-5, carriers exact, spectrum files
     identical), then a journal resume that reproduces table and spectrum
  6  ``scan --identity-mode columns --ehh`` on the same pangenome, GPU
     against CPU on 20 windows
  7  ``tajd``: ten 200 kb windows of the same pangenome as .npz tiles
     (native extractor), on the card and again on the CPU (integer columns
     exact, PI and D rtol 1e-5), with ``-s`` on one panel, then the whole
     2 Mb as one window, batched and streamed (``--stream-npy
     --chunk-sites 4096``): the two rows equal; and the ten windows again
     in device batches of 4 + 4 + 2: the rows of the one-batch run
  8  ``fused_window_stats(return_matrices=True)`` against
     ``return_matrices=False`` at [512, 128] x 320 (S and integers exact,
     floats rtol 1e-5, Fst atol 2e-3)
  A1 ``fused_window_stats(return_matrices=False)`` on [2, 512, 65 664], past
     the window kernel's cap, against ``window_stats_plain``: the composed
     route (identity, S, fused_panel_stats) by its launch counts
     (pairwise_identity > 0, window_stats == 0)
  9  the per-statistic commands on 200 consecutive 5 kb windows of the same
     pangenome as .npz tiles, on the card (two device batches of 128 and
     72 windows): ``pi -u agc.EUR``, ``hfst``, ``hud -m grouped`` and
     ``fst3pi`` on EUR / AFR, and ``panels-tajd`` (5 panels) on a metadata
     directory; on the first 20 windows ``pi -u agc.EUR -r 5`` and
     ``panels-hfst`` (10 pairs); then 20 windows as similarity TSVs through
     ``pi --sim-dir`` and ``hud -m direct --sim-dir``, and ``afs --input``
     on one of them.  Each command runs again on the first 20 windows on
     the CPU (integer columns exact, pi / Dxy rtol 1e-5, Fst / Da atol
     2e-3, NA in the same places; afs files identical); then the device
     steps alone, timed and profiled
  B1 ``ehh`` and ``sfs`` on the 400 windows as .npz tiles: ``ehh -p 250
     -w 500`` on their alt calls side by side (466 x 20 250: 40 windows
     and a ragged tail of 250 sites), with and without
     ``--compat-ehhgfa``, on the card and on the CPU (fields exact, areas
     rtol 1e-6), and in device batches of 8 windows (text identical);
     ``ehh --geno-dir`` at 50 focals spread over the tiles, card against
     CPU, and one focal alone against its rows in the run of 50; ``sfs``
     with the 5 panels, folded and ``--unfolded``, ``--per-window``: the
     files identical on the card, the CPU, one device batch and batches
     of 7 windows; ``spectrum --no-plots`` and ``makewindows``; then
     ``ehh_area`` timed at the matrix run's batch shape

  C1 the multi-device and multi-host paths on the one card: the scan's
     first 320 windows as one device batch (plain, then ``--identity-mode
     columns --ehh --afs``) through ``scan``, and that batch's step
     again under the sync debug mode "error" against the scan's step
     (integers exact, pi/D/EHH rtol 1e-5, Fst atol 2e-3; bitwise
     equality reported); the exact FSTG recompute
     (``scanstep.scan_step_fstg_exact``) of windows across the batch in
     one call against each window's own call, its identity kernel
     launched; then the same windows dealt by ``scan`` in four batches
     of 80 to [cuda:0] x 1, 2 and 4, three
     times in turns (``process_devices`` patched): batch j on entry j
     mod k, one ``scan_step`` each, the copy and the step on one stream,
     table, journal and spectrum byte-equal at every k, the scan's walls,
     and the dealt copy, step and copy back under the sync debug mode
     "error"; the dealt step timed per batch at 1, 2 and 4 entries, and
     the step alone; ``scan --distributed
     --afs`` in two processes on the card (gloo, ranks 0 and 1, one GPU
     each) merged by ``merge-parts`` / ``--sum`` against the tables of
     phases 3 and 5; ``pair_sharded_direct_stats`` on [cuda:0] x 4 at N =
     2048, S = 128, Q = 10 against the replicated [2048, 2048] identity,
     16 such windows in one call against 16 single calls and the
     replicated batch, timed per window, and ``hfst --pair-shard on``
     against ``off`` on 1200-row tiles;
     ``site_sharded_window_stats`` on a (2, 2) grid against (1, 1) at
     [512, 8192] x 8; ``parallel.dryrun.dryrun_multidevice(8, cuda:0)``
  D1 the measurement and verification entry points of
     ``impop_tpu_torch.bench`` on the card, small: ``python -m
     impop_tpu_torch.bench --batch 320 --iters 4 --e2e-mb 2`` (two
     baseline windows, one pass; its JSON line with bench.py's keys),
     ``check_device_oracle`` (8 windows, both routes against the float64
     oracle), ``gpu_smoke`` (cap 256 ``--ehh``; overlapping panels card
     against CPU), ``pairwise`` ([512, 8192]), ``panelstep`` ([512, 128] x
     320), ``windowstat`` (320 windows, then S = 128 .. 16 384 at 8
     windows, the routes agreeing); then the seed-pair debug guard with
     its flag set on the guard test's inputs (padded to N = 32).  All
     seven kernels must launch during D1.
  E1 the JAX package's acceptance workflows (tests/test_acceptance_hostile.py,
     tests/test_crash_resume.py) with ``--device cuda`` on its hostile
     chromosome (60 kb x 20 haplotypes, ragged coverage, p_indel 0.7,
     strand flips, a window past every alignment, a ghost panel): ``scan
     --ehh`` and ``scan --identity-mode columns --afs``, the crafted
     tiles through ``scan --geno-dir`` (multiallelic split, seed_risk
     recompute, a missing tile's NA record), ``extract`` then
     ``panels-tajd``, ``panels-hfst``, ``sfs`` and ``plot`` (where
     matplotlib is installed), each against ``--device cpu`` (integers
     exact, pi/D/EHH rtol 1e-5, Fst/Da atol 2e-3, NA in the same places,
     journals and spectrum files equal) and the scans against
     ``impop_tpu_torch/bench/oracle.py`` on every window with data; then
     a ``--device cuda`` scan killed with SIGKILL in a child process,
     resumed here: the table byte-equal to a clean card run.  The window
     kernel, seed peel, EHH, unit and weighted identity and masked sums
     must launch during E1; its walls are printed with the card's name
     and power limit.

Each main path (3-4, 5, 6, 7, 8, A1, 9, B1, C1, D1, E1) starts with every
kernel launch count at 0 and fails unless each kernel of that path was
launched during it.

Every kernel line of phase 2 gives its time, its plain version's, its bound
(the larger of its bytes over 3.35 TB/s and its operations over the H100
SXM peak for their type) with the share of it reached, and, for the two
identity kernels, one PyTorch call computing the same Grams (a yardstick
the port never calls).  Before the last line it prints the kernel table as
one JSON object and the card's name and power limit; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero without a result when CUDA is unavailable or when the
package is not beside this script.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
if not os.path.isdir(os.path.join(HERE, "impop_tpu_torch")):
    sys.exit("chip_smoke: impop_tpu_torch/ is not beside this script")
sys.path.insert(0, HERE)

from impop_tpu_torch.bench.inputs import (  # noqa: E402
    BATCH, CAP_N, CAP_S, N_HAP, PANEL_SIZES, THRESHOLD, WIN_BP, hprc_batch,
    long_batch, to_dev)
from impop_tpu_torch.bench.pairwise import zv_operands  # noqa: E402
from impop_tpu_torch.bench.roofline import (  # noqa: E402
    H100_BYTES_PER_S, bound, nbytes, nvidia_smi_line)

SCAN_BP = 2_000_000           # simulated pangenome for the scan phase
RTOL = 1e-5                   # floats: f32 sums in another order
ATOL = 1e-6
INT_KEYS = ("n", "num_groups", "pairs_used2", "cnt_aa", "cnt_bb", "cnt_ab",
            "s", "seed_risk")
FLOAT_KEYS = ("quad", "sum_aa", "sum_bb", "sum_ab", "gdxy")


class SmokeError(RuntimeError):
    pass


def tri_pairs(n: int) -> int:
    return n * (n + 1) // 2


def set_bound(report, name, ms, n_bytes, library_ms=None, **ops):
    """Record a kernel's bound (and yardstick) in the report; returns the
    text of the share."""
    b_ms, by = bound(n_bytes, **ops)
    report[name].update(bound_ms=b_ms, bound_by=by, library_ms=library_ms)
    return (f"bound {b_ms:.4f} ms ({by}), {100 * b_ms / ms:.1f}% of it"
            + ("" if library_ms is None else
               f"; one library call {library_ms:.4f} ms"))


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


# ------------------------------------------------------------------ phase 2


def compare_raw(got: dict, want: dict, tag: str) -> float:
    """Integers exact, floats within RTOL/ATOL; returns the max abs error."""
    import torch

    worst = 0.0
    for key in INT_KEYS + FLOAT_KEYS:
        g, w = got[key].double().cpu(), want[key].double().cpu()
        if g.shape != w.shape:
            raise SmokeError(f"{tag}: {key} shape {tuple(g.shape)} vs "
                             f"{tuple(w.shape)}")
        if not bool(torch.isfinite(g).all()):
            raise SmokeError(f"{tag}: {key} has non-finite values")
        err = float((g - w).abs().max()) if g.numel() else 0.0
        worst = max(worst, err)
        if key in INT_KEYS:
            if not torch.equal(g, w):
                raise SmokeError(f"{tag}: integer output {key} differs "
                                 f"(max abs {err})")
        elif not torch.allclose(g, w, rtol=RTOL, atol=ATOL):
            raise SmokeError(f"{tag}: {key} max abs err {err} beyond "
                             f"rtol {RTOL}")
    return worst


def window_case(dev, geno, member, smask, panels, lengths, pairs_disjoint,
                tag):
    """Kernel vs plain on one batch; returns (max abs err, inputs)."""
    from impop_tpu_torch.ops.windowstat import (window_stats,
                                                window_stats_plain)
    from impop_tpu_torch.stats.panelstats import panel_mask_stack

    p = panels.shape[1]
    pairs = [(i, j) for i in range(p) for j in range(i + 1, p)]
    pa, pb = tuple(a for a, _ in pairs), tuple(b for _, b in pairs)
    g, m, sm, pn, ln = to_dev(dev, geno, member, smask, panels, lengths)
    stack, ma, mb = panel_mask_stack(pn, m, pa, pb, pairs_disjoint)
    args = (g, m, sm, stack, ma, mb, THRESHOLD, ln, pa, pb, pairs_disjoint)
    got = window_stats(*args)
    want = window_stats_plain(*args)
    if dev.type == "cuda":
        import torch

        torch.cuda.synchronize()
    return compare_raw(got, want, tag), args, got


def cuda_time_ms(fn, reps: int) -> float:
    """Median milliseconds of fn() over reps, CUDA events, after warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def graph_ms(fn, reps: int) -> float:
    """Device milliseconds of fn() without the host's launch overhead
    (``impop_tpu_torch.bench.graph_ms``: CUDA graph replays)."""
    from impop_tpu_torch.bench import graph_ms as replay_ms

    return replay_ms(fn, reps)


def mid_active_focals(smask):
    """Per window, the middle active site (0 when the window has none)."""
    import numpy as np

    out = np.zeros(smask.shape[0], np.int32)
    for wi, row in enumerate(smask):
        idx = np.nonzero(row)[0]
        out[wi] = idx[len(idx) // 2] if idx.size else 0
    return out


def ehh_case(dev, geno, member, smask, focal, tag):
    """ehh_area against its plain version: sums and carriers exactly equal.
    Returns (max abs err, the largest step sum, the device inputs)."""
    import torch

    from impop_tpu_torch.ops.ehhdeath import ehh_area, ehh_area_plain

    args = to_dev(dev, geno, member, smask, focal)
    got = ehh_area(*args)
    want = ehh_area_plain(*args)
    torch.cuda.synchronize()
    for name, g, w in (("sums", got[0], want[0]), ("carriers", got[1],
                                                   want[1])):
        if g.shape != w.shape or not torch.equal(g, w):
            diff = (g.double() - w.double()).abs().max().item()
            raise SmokeError(f"{tag}: ehh_area {name} differ from the plain "
                             f"version (max abs {diff})")
    return 0.0, int(got[0].max()), args   # the largest per-direction sum


def phase_ehh_kernel(dev, report, profiles):
    import numpy as np

    from impop_tpu_torch.ops.ehhdeath import ehh_area, ehh_area_plain

    rng = np.random.default_rng(17)
    geno, member, smask, _, _ = hprc_batch(rng, BATCH)
    err, _, args = ehh_case(dev, geno, member, smask,
                            mid_active_focals(smask), "2f")
    ev_ms = cuda_time_ms(lambda: ehh_area(*args), 10)
    k_ms = graph_ms(lambda: ehh_area(*args), 10)
    p_ms = cuda_time_ms(lambda: ehh_area_plain(*args), 3)
    sums, carr = ehh_area(*args)
    c = carr.double()
    share = set_bound(report, "ehh_area", k_ms,
                      nbytes(*args, sums, carr),
                      int32=float((c * (c - 1)).sum()))  # 2 walks per pair
    say("2f", f"ehh_area [{CAP_N},{CAP_S}]x{BATCH}, focal at the middle "
        f"variant: sums and carriers exactly equal; kernel {k_ms:.4f} "
        f"ms/batch (CUDA graph replays; with the wrapper's host time, CUDA "
        f"events: {ev_ms:.4f}) = {k_ms / BATCH * 1e3:.3f} us/window; plain "
        f"{p_ms:.4f} ms/batch = {p_ms / BATCH * 1e3:.3f} us/window; {share}")
    profiles.append(("2f", f"ehh_area [{CAP_N},{CAP_S}]x{BATCH} by launch "
                     "(torch.profiler, one call): ",
                     lambda: ehh_area(*args), k_ms))

    # focal on the first / last active site; a window with no active site
    geno, member, smask, _, _ = hprc_batch(rng, 6)
    smask &= rng.random(smask.shape) < 0.8
    smask[5] = False
    focal = np.zeros(6, np.int32)
    for wi in range(5):
        idx = np.nonzero(smask[wi])[0]
        focal[wi] = idx[0] if wi % 2 == 0 else idx[-1]
    ehh_case(dev, geno, member, smask, focal, "2f edges")

    # [512, 1024]: long identical runs, step sums past 2^24
    geno, member, smask, _, _ = hprc_batch(rng, 16, cap_s=1024)
    for wi in range(16):
        classes = rng.integers(0, 2, size=(2, 1024)).astype(np.int8)
        g = classes[rng.integers(0, 2, size=N_HAP)]
        geno[wi, :N_HAP] = np.where(rng.random((N_HAP, 1024)) < 2e-4,
                                    1 - g, g)
    smask[:] = True
    _, big, long_args = ehh_case(dev, geno, member, smask,
                                 mid_active_focals(smask), "2f long")
    if big <= 1 << 24:
        raise SmokeError(f"2f long: largest step sum {big} does not pass "
                         "2^24")
    long_ms = graph_ms(lambda: ehh_area(*long_args), 10)
    long_plain = cuda_time_ms(lambda: ehh_area_plain(*long_args), 3)

    # [512, 4096]: the pair walk reads its words from device memory
    geno, member, smask, _, _ = hprc_batch(rng, 4, cap_s=4096)
    geno[:, :N_HAP] = np.where(rng.random((4, N_HAP, 4096)) < 0.02, 1,
                               0).astype(np.int8)
    smask[:] = True
    ehh_case(dev, geno, member, smask, mid_active_focals(smask),
             "2f unstaged")
    say("2f", f"ehh_area edges (first / last active focal, no active "
        f"site), [512,4096]x4 (words read from device memory) and "
        f"[512,1024]x16 (largest sum {big} > 2^24): exactly equal; "
        f"[512,1024]x16 kernel {long_ms:.4f} ms (CUDA graph replays), plain "
        f"{long_plain:.4f} ms")
    report["ehh_area"].update(max_abs_err=err, ms=k_ms, plain_ms=p_ms)


def phase_weighted_kernels(dev, report, profiles):
    import numpy as np
    import torch

    from impop_tpu_torch.ops.panelquad import (masked_pair_sums,
                                               masked_pair_sums_plain)
    from impop_tpu_torch.ops.pairdiff import (
        pairwise_identity, pairwise_identity_weighted,
        pairwise_identity_weighted_plain)
    from impop_tpu_torch.stats.panelstats import (gdxy_rows,
                                                  panel_mask_stack,
                                                  panel_sums)

    rng = np.random.default_rng(23)
    w_cols = 64

    def weighted(geno, member, smask, lengths, wts, tag, tol=None):
        """Integer weights: exactly equal; ``tol`` (non-integer weights):
        present equal and sim within tol."""
        args = to_dev(dev, geno, member, smask, lengths, wts)
        sim, pres = pairwise_identity_weighted(*args)
        sim_p, pres_p = pairwise_identity_weighted_plain(*args)
        torch.cuda.synchronize()
        if not torch.equal(pres, pres_p):
            raise SmokeError(f"{tag}: weighted present differs")
        err = float((sim - sim_p).abs().max()) if sim.numel() else 0.0
        if (tol is None and not torch.equal(sim, sim_p)) or \
                (tol is not None and err > tol):
            raise SmokeError(f"{tag}: weighted sim differs (max abs {err})")
        return args, sim, pres, err

    geno, member, smask, panels, lengths = hprc_batch(rng, w_cols)
    wts = rng.integers(1, 51, size=(w_cols, CAP_S)).astype(np.float32)
    wts[:, 7] = 100_000.0
    args, sim, pres, _ = weighted(geno, member, smask, lengths, wts, "2g")
    k_ms = graph_ms(lambda: pairwise_identity_weighted(*args), 10)
    p_ms = graph_ms(lambda: pairwise_identity_weighted_plain(*args), 5)
    ev_ms = cuda_time_ms(lambda: pairwise_identity_weighted(*args), 10)
    # yardstick: one fp32 bmm (TF32 off) of [a·w | c·w] x [c | a]^T
    g_t, m_t, sm_t, _, w_t = args
    valid = (g_t >= 0) & m_t[..., :, None] & sm_t[..., None, :]
    a_op = (valid & (g_t > 0)).float()
    c_op = valid.float() - a_op
    lhs = torch.cat([a_op * w_t[:, None], c_op * w_t[:, None]], -1)
    rhs = torch.cat([c_op, a_op], -1).transpose(1, 2).contiguous()
    torch.backends.cuda.matmul.allow_tf32 = False
    lib_ms = graph_ms(lambda: torch.bmm(lhs, rhs), 10)
    del valid, a_op, c_op, lhs, rhs
    share = set_bound(
        report, "pairwise_identity_weighted", k_ms,
        nbytes(*args, sim, pres), lib_ms,
        bf16=4 * w_cols * tri_pairs(CAP_N) * CAP_S,
        int8=2 * w_cols * tri_pairs(CAP_N) * CAP_S)
    g4, m4, s4, _, l4 = hprc_batch(rng, 4, cap_s=4096)
    g4[:, :N_HAP] = np.where(rng.random((4, N_HAP, 4096)) < 0.02, 1,
                             0).astype(np.int8)
    s4[:] = True
    l4[:] = 200_000.0
    w4 = rng.integers(1, 51, size=(4, 4096)).astype(np.float32)
    weighted(g4, m4, s4, l4, w4, "2g long")
    # ragged shapes, all-ones and SV weights, non-integer weights
    cases = []
    for w, n, s, kind in ((3, 37, 37, "int"), (2, 37, 1, "int"),
                          (2, 1024, 3120, "int"), (4, CAP_N, CAP_S, "ones"),
                          (3, 300, 640, "frac")):
        gr, mr, sr, _, lr = hprc_batch(rng, w, cap_n=n, cap_s=s,
                                       n_hap=min(n, N_HAP) - 1)
        sr[:] = True
        if kind == "ones":
            wr = np.ones((w, s), np.float32)
        elif kind == "frac":
            wr = rng.uniform(0.0, 50.0, (w, s)).astype(np.float32)
        else:   # 1-50 and every 97th column an SV of 100 000 bp: the
            # per-pair sums stay below 2^24, where integers are exact
            wr = rng.integers(1, 51, (w, s)).astype(np.float32)
            wr[:, ::97] = 100_000.0
        # non-integer weights: the float32 sums run in another order
        tol = (1e-5 * float(wr.sum(axis=1).max()) / WIN_BP + 1e-6
               if kind == "frac" else None)
        err = weighted(gr, mr, sr, lr, wr, f"2g [{n},{s}]x{w} {kind}",
                       tol)[3]
        cases.append(f"[{n},{s}]x{w} {kind}"
                     + (f" (max abs {err:.2e} <= {tol:.2e})" if tol else ""))
    say("2g", f"pairwise_identity_weighted [{CAP_N},{CAP_S}]x{w_cols} "
        f"(weights 1-50, one 100 000 bp column), [512,4096]x4 and "
        f"{', '.join(cases)}: sim and present exactly equal (non-integer "
        f"weights: present equal, sim within 1e-5 of the weight mass per bp "
        f"+ 1e-6); device times (CUDA graph replays): kernel {k_ms:.4f} "
        f"ms/batch (with the wrapper's host time, CUDA events: {ev_ms:.4f}) = "
        f"{k_ms / w_cols * 1e3:.3f} us/window; plain {p_ms:.4f} ms/batch = "
        f"{p_ms / w_cols * 1e3:.3f} us/window; {share} (fp32 bmm, TF32 off)")
    report["pairwise_identity_weighted"].update(max_abs_err=0.0, ms=k_ms,
                                                plain_ms=p_ms)

    # the row stacks fused_panel_stats hands to the masked sums
    m_dev = args[1]
    p = panels.shape[1]
    pairs = [(i, j) for i in range(p) for j in range(i + 1, p)]
    pa, pb = tuple(a for a, _ in pairs), tuple(b for _, b in pairs)
    overlap = torch.from_numpy(rng.random((w_cols, p, CAP_N)) < 0.3).to(dev)
    cases = []
    for disjoint, pn in ((True, to_dev(dev, panels)[0]), (False, overlap)):
        stack, ma, mb = panel_mask_stack(pn, m_dev, pa, pb, disjoint)
        pq = p + len(pairs)
        ia, ib = gdxy_rows(pa, pb, pq, disjoint)
        seen = {}

        def capture(*xs):
            seen["args"] = xs
            return masked_pair_sums_plain(*xs)

        panel_sums(sim, pres, m_dev, stack, ma, mb, THRESHOLD, ia, ib, pq,
                   pair_sums=capture)
        cases.append((f"columns scan, disjoint={disjoint}", seen["args"]))
    timed = cases[0][1]
    # a Wp that is not 0/1 (one weight row among the 0/1 rows): the fp32
    # branch of the kernel's row check
    wp_vals = timed[3].clone()
    wp_vals[:, 0] = timed[2][:, 0]
    cases.append(("Wp not 0/1", (*timed[:3], wp_vals)))
    # the drivers' shape: [512,512] x 128 with the 2 + 2 rows that
    # batch_hudson direct hands over (stats/fst.hudson_fst_direct_pairs:
    # [a; b] for one pair, EUR against AFR)
    w_drv = 128
    g_d, m_d, sm_d, pn_d, ln_d = to_dev(dev, *hprc_batch(rng, w_drv))
    sim_d, pres_d = pairwise_identity(g_d, m_d, sm_d, ln_d)
    names = list(PANEL_SIZES)
    ab = torch.stack([pn_d[:, names.index("EUR")] & m_d,
                      pn_d[:, names.index("AFR")] & m_d], 1).float()
    drivers = (sim_d, pres_d, ab, ab)
    cases.append(("drivers (batch_hudson direct)", drivers))
    # a wide window: 65 column tiles of 64
    n_big = 4160
    big = [torch.from_numpy(a).to(dev) for a in (
        rng.random((2, n_big, n_big), np.float32),
        np.triu(rng.random((2, n_big, n_big)) < 0.9),
        rng.random((2, 2, n_big), np.float32),
        (rng.random((2, 2, n_big)) < 0.3).astype(np.float32))]
    big[1] = big[1] | big[1].transpose(1, 2).clone()
    big[1][:, 5, 7] = False                       # not symmetric
    cases.append((f"N = {n_big} (65 column tiles)", tuple(big)))
    # stacks past a block's two 64-row tiles: each further layer of two
    # tiles reads sim / present again; 128 + 140 and 256 + 140 rows are
    # three and four layers, 150 + 140 is the tests' shape
    layers = {}
    for rd_ in (128, 256, 150):
        wd_ = rng.random((w_cols, rd_, CAP_N), np.float32)
        wd_ *= rng.random((w_cols, rd_, CAP_N)) < 0.4
        wp_ = (rng.random((w_cols, 140, CAP_N)) < 0.3).astype(np.float32)
        layers[rd_] = (f"{rd_} + 140 rows", (*timed[:2], *to_dev(dev, wd_,
                                                                  wp_)))
        cases.append(layers[rd_])
    worst = 0.0
    for tag, xs in cases:
        got = masked_pair_sums(*xs)
        want = masked_pair_sums_plain(*xs)
        torch.cuda.synchronize()
        binary = ((xs[3] == 0) | (xs[3] == 1)).all(dim=-1)
        if not torch.equal(got[1][binary], want[1][binary]):
            raise SmokeError(f"2h {tag}: masked_pair_sums Yp of 0/1 rows "
                             "differs from the plain version")
        for g, w in zip(got, want):
            err = float((g - w).abs().max())
            worst = max(worst, err)
            if not torch.allclose(g, w, rtol=RTOL, atol=ATOL):
                raise SmokeError(f"2h {tag}: masked_pair_sums beyond rtol "
                                 f"{RTOL} (max abs {err})")
    if bool(((wp_vals == 0) | (wp_vals == 1)).all()):
        raise SmokeError("2h: the Wp with other values is 0/1")

    def sums_bound(xs):
        """(bytes, fp32 flops, int32 ops, old all-fp32 flops): Yd rows and
        Wp rows that are not 0/1 as fp32 FMAs, 0/1 rows of Wp as AND +
        popcount + add per 32 pairs; bytes sim + present + rows +
        outputs."""
        s_, p_, wd_, wp_ = xs
        w_, n_ = s_.shape[0], s_.shape[-1]
        n_bin = int(((wp_ == 0) | (wp_ == 1)).all(dim=-1).sum())
        pairs_ = n_ * n_
        fp32 = 2 * pairs_ * (w_ * wd_.shape[-2] + w_ * wp_.shape[-2] - n_bin)
        int32 = 3 * (pairs_ // 32) * n_bin
        old = 2 * w_ * pairs_ * (wd_.shape[-2] + wp_.shape[-2])
        return nbytes(*xs) + nbytes(*masked_pair_sums(*xs)), fp32, int32, old

    def piece_flops(x, n_, b_pieces):
        """bf16 FLOPs of the value-row product on the tensor cores for a
        row stack x [W, R, N]: per 64-row tile the kept piece products
        against b_pieces pieces of B (six against (1 - sim) . mask, three
        against the mask; three and one when the tile's rows are all 0/1),
        each a 64 x N x N product over whole chunks and column tiles."""
        w_, r_ = x.shape[0], x.shape[-2]
        tiles = -(-r_ // 64)
        binary = torch.ones((w_, 64 * tiles), dtype=torch.bool,
                            device=x.device)
        binary[:, :r_] = ((x == 0) | (x == 1)).all(dim=-1)
        values = int((~binary.view(w_, tiles, 64).all(-1)).sum())
        per = 2 * 64 * (-(-n_ // 32) * 32) * (-(-n_ // 64) * 64)
        full, zero_one = (6, 3) if b_pieces == 3 else (3, 1)
        return per * (full * values + zero_one * (w_ * tiles - values))

    def bmm_pair(xs):
        """The two fp32 bmm (TF32 off) on precomputed (1 - sim) . mask and
        mask: a comparison, not the yardstick (the pass that builds them
        is left out)."""
        s_, p_, wd_, wp_ = xs
        eye = torch.eye(s_.shape[-1], dtype=torch.bool, device=s_.device)
        mask = p_ & ~eye
        div = torch.where(mask, 1.0 - s_, 0.0)
        maskf = mask.float()
        return lambda: (torch.bmm(wd_, div), torch.bmm(wp_, maskf))

    lines, times = [], {}
    for tag, xs in (cases[0], cases[2], cases[3], layers[128], layers[256]):
        k_ms = graph_ms(lambda: masked_pair_sums(*xs), 20)
        ev_ms = cuda_time_ms(lambda: masked_pair_sums(*xs), 20)
        p_ms = cuda_time_ms(lambda: masked_pair_sums_plain(*xs), 5)
        bmm_ms = graph_ms(bmm_pair(xs), 10)
        n_bytes, fp32, int32, old = sums_bound(xs)
        b_ms, by = bound(n_bytes, fp32=fp32, int32=int32)
        old_ms, old_by = bound(n_bytes, fp32=old)
        w_ = xs[0].shape[0]
        tc = (piece_flops(xs[2], xs[0].shape[-1], 3)
              + piece_flops(xs[3], xs[0].shape[-1], 1))
        times[tag] = k_ms
        lines.append(
            f"{tag}, [{CAP_N},{CAP_N}]x{w_}, {xs[2].shape[-2]} + "
            f"{xs[3].shape[-2]} rows: kernel {k_ms:.4f} ms/batch (CUDA graph "
            f"replays; with the wrapper's host time, CUDA events: "
            f"{ev_ms:.4f}) = {k_ms / w_ * 1e3:.3f} us/window; plain "
            f"{p_ms:.4f} ms; bound {b_ms:.4f} ms ({by}), "
            f"{100 * b_ms / k_ms:.1f}% of it (all rows as fp32 FMAs: "
            f"{old_ms:.4f} ms, {old_by}); tensor cores {tc / 1e9:.2f} GFLOP "
            f"of bf16 pieces ({bound(0, bf16=tc)[0]:.4f} ms at the bf16 "
            f"peak); two fp32 bmm on precomputed operands {bmm_ms:.4f} ms")
        if tag == cases[0][0]:
            share = set_bound(report, "masked_pair_sums", k_ms, n_bytes,
                              fp32=fp32, int32=int32)
            report["masked_pair_sums"].update(max_abs_err=worst, ms=k_ms,
                                              plain_ms=p_ms)
    say("2h", "masked_pair_sums on the columns scan's stacks (disjoint and "
        "overlapping pairs), a Wp that is not 0/1, the drivers' "
        f"[{CAP_N},{CAP_N}]x{w_drv} 2 + 2 rows, N = {n_big} and 128 / 256 / "
        f"150 value rows + 140 0/1 rows: 0/1 rows of Yp exactly equal, the "
        f"rest within rtol {RTOL} (max_abs_err {worst:.3e})")
    for line in lines:
        say("2h", line)
    # what a further layer's read of sim / present costs: the time per
    # value row at four layers against three, and the read alone at the
    # card's memory rate
    t1, t2 = times[layers[128][0]], times[layers[256][0]]
    reread_ms = bound(nbytes(*timed[:2]))[0]
    say("2h", f"stacks past two tiles: 128 + 140 rows (three layers) "
        f"{t1 / 128 * 1e3:.3f} us per value row, 256 + 140 (four layers) "
        f"{t2 / 256 * 1e3:.3f} us ({t2 / t1:.3f}x the time for 2x the value "
        f"rows); one read of sim / present alone {reread_ms:.4f} ms at "
        f"{H100_BYTES_PER_S / 1e12} TB/s")
    say("2h", f"in the report: {share}")
    for tag, xs in (cases[0], cases[3]):
        profiles.append(("2h", f"masked_pair_sums {tag} by launch "
                         "(torch.profiler, one call): ",
                         lambda xs=xs: masked_pair_sums(*xs), times[tag]))


def phase_kernels(dev, report, profiles):
    """2a-2e; the window kernel's per-launch profiles go to ``profiles``,
    taken after every kernel of phase 2 is timed (a torch.profiler session
    leaves later kernel times a little slower)."""
    import numpy as np
    import torch

    from impop_tpu_torch.ops.pairdiff import pairwise_identity_plain
    from impop_tpu_torch.ops.seedpeel import seed_gid_plain, seed_peel
    from impop_tpu_torch.ops.windowstat import (window_stats,
                                                window_stats_plain)
    from impop_tpu_torch.stats.allele import identity_from_alleles

    rng = np.random.default_rng(7)
    # (a) the HPRC shape
    batch = hprc_batch(rng, BATCH)
    err_a, args, got = window_case(dev, *batch, True, "2a")
    k_ms = cuda_time_ms(lambda: window_stats(*args), 10)
    p_ms = cuda_time_ms(lambda: window_stats_plain(*args), 3)
    g, m, sm, stack, ma, mb = args[:6]
    r, q = stack.shape[-2], ma.shape[-2]
    value_rows = r + 2 * q    # X . (1 - sim) rows: fp32 FMAs
    mask_rows = r + 2 * q     # 0/1 rows . present (disjoint: PQ = R): per
    #                           32-bit word an AND, a popcount and an add
    in_out = nbytes(g, m, sm, stack, ma, mb, args[7], *got.values())
    gram = 4 * BATCH * tri_pairs(CAP_N) * CAP_S
    # phase C's yardstick: one fp32 bmm (TF32 off) of value rows against a
    # precomputed (1 - sim) . mask; the port never calls it
    sim_p, pres_p = pairwise_identity_plain(g, m, sm, args[7])
    eye = torch.eye(CAP_N, dtype=torch.bool, device=dev)
    div = torch.where(pres_p & ~eye, 1.0 - sim_p, 0.0)
    rd = -(-value_rows // 16) * 16
    x_rows = torch.rand((BATCH, rd, CAP_N), device=dev)
    yard_ms = graph_ms(lambda: torch.bmm(x_rows, div), 10)
    share = set_bound(
        report, "window_stats", k_ms, in_out, library_ms=yard_ms, int8=gram,
        fp32=2 * BATCH * CAP_N * CAP_N * value_rows,
        int32=3 * BATCH * mask_rows * CAP_N * (CAP_N // 32))
    # PR 5's count, every product row as fp32 FMAs, kept for comparison
    # with the shares recorded before (not a bound: the 0/1 rows need none)
    old_ms = bound(in_out, int8=gram,
                   fp32=2 * BATCH * CAP_N * CAP_N * (value_rows + mask_rows))[0]
    # the tensor-core design's own counts: per 64-row tile of value rows the
    # six kept bf16 piece products (three for a tile of 0/1 rows only) of
    # a 64 x N x N product, and phase C's read of diff (uint16)
    tiles, weight_tiles = -(-rd // 64), -(-r // 64)
    tc = (2 * 64 * CAP_N * CAP_N * BATCH
          * (6 * weight_tiles + 3 * (tiles - weight_tiles)))
    diff_bytes = 2 * BATCH * CAP_N * CAP_N
    say("2a", f"window_stats [{CAP_N},{CAP_S}]x{BATCH} 5 panels/10 pairs "
        f"disjoint: integers exact, floats within rtol {RTOL} (max_abs_err "
        f"{err_a:.3e}); kernel {k_ms:.4f} ms/batch "
        f"= {k_ms / BATCH * 1e3:.3f} us/window; plain {p_ms:.4f} ms/batch "
        f"= {p_ms / BATCH * 1e3:.3f} us/window; {share}; PR 5's count (all "
        f"{value_rows + mask_rows} product rows as fp32 FMAs) {old_ms:.4f} "
        f"ms, {100 * old_ms / k_ms:.1f}% of it; phase C on the tensor cores: "
        f"{tc / 1e9:.1f} GFLOP of bf16 pieces ({bound(0, bf16=tc)[0]:.4f} "
        f"ms at the bf16 peak), diff {diff_bytes / 1e6:.0f} MB "
        f"({bound(diff_bytes)[0]:.4f} ms); phase C's yardstick, one fp32 "
        f"bmm [{BATCH},{rd},{CAP_N}] x [{CAP_N},{CAP_N}] (TF32 off): "
        f"{yard_ms:.4f} ms")
    profiles.append(("2a", "window_stats by phase kernel (torch.profiler, "
                     "one call): ", lambda: window_stats(*args), k_ms))
    report["window_stats"].update(max_abs_err=err_a, ms=k_ms, plain_ms=p_ms)

    # (b) cap 256, overlapping panels (non-disjoint layout); ten
    # overlapping panels (X stacks of 400 rows: phase C reads its X columns
    # from device memory); cap 1152 (phase B reads the link bits from
    # device memory)
    geno, member, smask, _, lengths = hprc_batch(rng, 64, cap_n=256,
                                                 n_hap=230)
    panels = rng.random((64, 4, 256)) < 0.4
    err_b, _, _ = window_case(dev, geno, member, smask, panels, lengths,
                              False, "2b")
    geno, member, smask, _, lengths = hprc_batch(rng, 16, cap_n=256,
                                                 n_hap=230)
    panels = rng.random((16, 10, 256)) < 0.3
    err_b = max(err_b, window_case(dev, geno, member, smask, panels, lengths,
                                   False, "2b ten panels")[0])
    batch = hprc_batch(rng, 8, cap_n=1152, n_hap=1100)
    err_b = max(err_b, window_case(dev, *batch, True, "2b cap 1152")[0])
    say("2b", f"window_stats [256,128]x64 overlapping panels, [256,128]x16 "
        f"ten overlapping panels, [1152,128]x8: max_abs_err {err_b:.3e}")

    # (c) partial coverage: two coverage islands -> seed_risk
    geno, member, smask, _, lengths = hprc_batch(rng, 4, cap_n=128,
                                                 n_hap=120)
    geno[:, :60, 64:] = -1
    geno[:, 60:, :64] = -1
    smask[:] = True
    panels = np.zeros((4, 2, 128), bool)
    panels[:, 0, :60] = True
    panels[:, 1, 60:120] = True
    err_c, _, got_c = window_case(dev, geno, member, smask, panels, lengths,
                                  True, "2c")
    if not bool((got_c["seed_risk"] > 0.5).all()):
        raise SmokeError("2c: partial-coverage windows did not set "
                         "seed_risk")
    say("2c", f"window_stats partial coverage: seed_risk set in all 4, "
        f"max_abs_err {err_c:.3e}")

    # (d) a long window, cap_s = 4096
    geno, member, smask, panels, lengths = hprc_batch(rng, 8, cap_s=4096)
    geno[:, :N_HAP, :4096] = np.where(
        rng.random((8, N_HAP, 4096)) < 0.02, 1, 0).astype(np.int8)
    smask[:] = True
    lengths[:] = 200_000.0
    err_d, args_d, _ = window_case(dev, geno, member, smask, panels,
                                   lengths, True, "2d")
    d_ms = cuda_time_ms(lambda: window_stats(*args_d), 10)
    say("2d", f"window_stats [512,4096]x8: max_abs_err {err_d:.3e}; kernel "
        f"{d_ms:.4f} ms/batch")
    profiles.append(("2d", "window_stats [512,4096]x8 by phase kernel "
                     "(torch.profiler, one call): ",
                     lambda: window_stats(*args_d), d_ms))
    report["window_stats"]["max_abs_err"] = max(err_a, err_b, err_c, err_d)

    # (e) seed_peel: one window with 2Q = 20 masks (the recompute's
    # shape), tajd's ten windows with one mask, phase 9's 200 windows with
    # two panels; seeds and gid against the plain composition
    lines = []
    for w, p in ((1, 20), (10, 1), (200, 2)):
        g, m, sm, _, ln = to_dev(dev, *hprc_batch(rng, w))
        sim, present = identity_from_alleles(g, m, sm, ln)
        masks = torch.from_numpy(rng.random((w, p, CAP_N)) < 0.3).to(dev)
        masks[:, 0] = True
        peel_args = (sim, present, m, masks, THRESHOLD)
        seeds, gid = seed_peel(*peel_args)
        want_seeds, want_gid = seed_gid_plain(*peel_args)
        if not (torch.equal(seeds, want_seeds) and torch.equal(gid, want_gid)):
            raise SmokeError(f"2e: seed_peel seeds or gid differ from the "
                             f"plain composition at [{CAP_N},{CAP_N}]x{w}, "
                             f"{p} masks")
        ev_ms = cuda_time_ms(lambda: seed_peel(*peel_args), 20)
        k_ms = graph_ms(lambda: seed_peel(*peel_args), 20)
        p_ms = cuda_time_ms(lambda: seed_gid_plain(*peel_args), 5)
        # link(j, i) reads sim and present at j < i only: the strict upper
        # triangles are the bytes the function must move
        upper = w * CAP_N * (CAP_N - 1) // 2 * (sim.element_size()
                                                 + present.element_size())
        n_bytes = upper + nbytes(m, masks, seeds, gid)
        b_ms, by = bound(n_bytes)
        chain = int(seeds.sum(-1).max())
        lines.append(f"[{CAP_N},{CAP_N}]x{w}, {p} masks: kernel {k_ms:.4f} "
                     f"ms (CUDA graph replays; with the wrapper's host time, "
                     f"CUDA events: {ev_ms:.4f}), plain {p_ms:.4f} ms; "
                     f"longest seed chain {chain} steps; bound {b_ms:.4f} ms "
                     f"({by}), {100 * b_ms / k_ms:.1f}% of it")
        if w == 1:
            set_bound(report, "seed_peel", k_ms, n_bytes)
            report["seed_peel"].update(max_abs_err=0.0, ms=k_ms,
                                       plain_ms=p_ms)
        if w == 200:
            profiles.append(("2e", f"seed_peel [{CAP_N},{CAP_N}]x{w}, {p} "
                             "masks by launch (torch.profiler, one call): ",
                             lambda a=peel_args: seed_peel(*a), k_ms))
    say("2e", "seed_peel seeds and gid equal to the plain composition; "
        + "; ".join(lines))


def phase_identity_kernel(dev, report):
    import numpy as np
    import torch

    from impop_tpu_torch.ops.pairdiff import (KT_UNIT,
                                              _pairwise_identity_cuda,
                                              identity_partition,
                                              pairwise_identity,
                                              pairwise_identity_plain)

    rng = np.random.default_rng(29)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def case(arrays, tag):
        args = to_dev(dev, *arrays)
        sim, pres = pairwise_identity(*args)
        sim_p, pres_p = pairwise_identity_plain(*args)
        torch.cuda.synchronize()
        if not torch.equal(pres, pres_p):
            raise SmokeError(f"{tag}: unit-weight present differs")
        if not torch.equal(sim, sim_p):
            err = float((sim - sim_p).abs().max())
            raise SmokeError(f"{tag}: unit-weight sim differs (max abs "
                             f"{err})")
        return args, sim, pres

    times = []
    for w, s in ((64, 2048), (8, 8192), (10, 3200)):
        args, sim, pres = case(long_batch(rng, w, cap_s=s), f"2i [512,{s}]")
        k_ms = graph_ms(lambda: pairwise_identity(*args), 10)
        p_ms = graph_ms(lambda: pairwise_identity_plain(*args), 5)
        ev_ms = cuda_time_ms(lambda: pairwise_identity(*args), 10)
        x = zv_operands(*args[:3])
        xt = x.transpose(1, 2).contiguous()
        lib_ms = graph_ms(lambda: torch.bmm(x, xt), 10)
        b_ms, by = bound(nbytes(*args, sim, pres),
                         int8=4 * w * tri_pairs(CAP_N) * s)
        splits = identity_partition(w, CAP_N, s, KT_UNIT, sms)[2]
        sweep = {k: graph_ms(
            lambda: _pairwise_identity_cuda(*args, splits=k), 10)
            for k in (1, 2, 3, 4, 5, 6, 8)}
        times.append((w, s, k_ms, p_ms, lib_ms, b_ms, by, splits, sweep,
                      ev_ms))
        if s == 2048:
            share = set_bound(report, "pairwise_identity", k_ms,
                              nbytes(*args, sim, pres), lib_ms,
                              int8=4 * w * tri_pairs(CAP_N) * s)
        del args, sim, pres, x, xt
    case(long_batch(rng, 4, cap_n=1024, n_hap=1000), "2i [1024,2048]")
    geno, member, smask, lengths = long_batch(rng, 4, cap_s=256)
    geno = np.where(geno > 0, rng.integers(1, 4, size=geno.shape),
                    geno).astype(np.int8)
    geno[:, 3] = -1
    lengths[:] = 0.0
    case((geno, member, smask, lengths), "2i codes")
    geno, member, smask, lengths = long_batch(rng, 3, cap_n=200, cap_s=300,
                                              n_hap=190)
    geno = np.where(geno > 0, rng.integers(1, 64, size=geno.shape),
                    geno).astype(np.int8)
    case((geno, member, smask, lengths), "2i codes to 63")
    ragged = []
    for w, n, s in ((3, 37, 37), (2, 37, 1), (2, 1024, 3120)):
        arrays = long_batch(rng, w, cap_n=n, cap_s=s, n_hap=n - 1)
        arrays[2][:] = True
        case(arrays, f"2i [{n},{s}]x{w}")
        ragged.append(f"[{n},{s}]x{w}")
    say("2i", "pairwise_identity at [512,2048]x64, [512,8192]x8, "
        "[512,3200]x10, [1024,2048]x4, codes up to 3 (a member without "
        "calls, length 0) and up to 63, " + ", ".join(ragged) + ": sim and "
        "present exactly equal")
    for w, s, k, p, lib, b, by, splits, sweep, ev in times:
        say("2i", f"[512,{s}]x{w}, device times (CUDA graph replays): kernel "
            f"{k:.4f} ms/batch = {k / w * 1e3:.3f} us/window ({splits} site "
            f"splits; with the wrapper's host time, CUDA events: {ev:.4f}), "
            "plain "
            f"{p:.4f} ms; bound {b:.4f} ms ({by}), {100 * b / k:.1f}% of it;"
            f" one bf16 bmm of [z; v] {lib:.4f} ms; by forced splits: "
            + ", ".join(f"{n_} {t:.4f}" for n_, t in sweep.items()))
    w, s, k_ms, p_ms = times[0][:4]
    say("2i", f"[512,2048]x64 in the report: {share}")
    report["pairwise_identity"].update(max_abs_err=0.0, ms=k_ms,
                                       plain_ms=p_ms)


def phase_idgroup_kernel(dev, report, profiles):
    import numpy as np
    import torch

    from impop_tpu_torch.ops.idgroup import (identity_group,
                                             identity_group_plain)
    from impop_tpu_torch.stats.panelstats import panel_mask_stack

    rng = np.random.default_rng(31)

    def case(geno, member, smask, panels, lengths, disjoint, tag):
        p = panels.shape[1]
        pairs = [(i, j) for i in range(p) for j in range(i + 1, p)]
        g, m, sm, pn, ln = to_dev(dev, geno, member, smask, panels, lengths)
        stack = panel_mask_stack(pn, m, tuple(a for a, _ in pairs),
                                 tuple(b for _, b in pairs), disjoint)[0]
        args = (g, m, sm, stack, THRESHOLD, ln)
        got = identity_group(*args)
        want = identity_group_plain(*args)
        torch.cuda.synchronize()
        for name, a, b in zip(("sim", "present", "gid", "S"), got, want):
            if not torch.equal(a, b):
                raise SmokeError(f"{tag}: identity_group {name} differs from "
                                 "the plain version")
        return args, stack.shape[-2]

    args, r = case(*hprc_batch(rng, BATCH), True, "2j")
    k_ms = graph_ms(lambda: identity_group(*args), 20)
    ev_ms = cuda_time_ms(lambda: identity_group(*args), 10)
    p_ms = cuda_time_ms(lambda: identity_group_plain(*args), 3)
    share = set_bound(report, "identity_group", k_ms,
                      nbytes(*args[:4], args[5], *identity_group(*args)),
                      int8=4 * BATCH * tri_pairs(CAP_N) * CAP_S)
    geno, member, smask, _, lengths = hprc_batch(rng, 64, cap_n=256,
                                                 n_hap=230)
    _, r_b = case(geno, member, smask, rng.random((64, 4, 256)) < 0.4,
                  lengths, False, "2j overlap")
    case(*hprc_batch(rng, 4, cap_n=1152), True, "2j 1152")
    # past kBitsMaxSites = 512 sites the pair blocks take present from
    # OR-ed words, and pairs that differ at more than 1024 sites take sim
    # by division, not from the block's table
    args4 = case(*hprc_batch(rng, 8, cap_s=4096), True, "2j 4096")[0]
    sim4, pres4 = identity_group(*args4)[:2]
    if not bool((sim4[pres4] < 1.0 - 1024.0 / WIN_BP).any()):
        raise SmokeError("2j 4096: no pair differs at more than 1024 sites")
    say("2j", f"identity_group [{CAP_N},{CAP_S}]x{BATCH} R = {r}, "
        f"[256,128]x64 overlapping panels R = {r_b}, [1152,{CAP_S}]x4 "
        f"(link words read from device memory) and [{CAP_N},4096]x8 (present "
        f"from OR-ed words, pairs past the sim table's 1024 differing "
        f"sites): sim, present, gid and S "
        f"exactly equal; kernel {k_ms:.4f} ms/batch (CUDA graph replays; "
        f"with the wrapper's host time, CUDA events: {ev_ms:.4f}) = "
        f"{k_ms / BATCH * 1e3:.3f} us/window; plain {p_ms:.4f} ms/batch = "
        f"{p_ms / BATCH * 1e3:.3f} us/window; {share}")
    report["identity_group"].update(max_abs_err=0.0, ms=k_ms, plain_ms=p_ms)
    profiles.append(("2j", f"identity_group [{CAP_N},{CAP_S}]x{BATCH} by "
                     "launch (torch.profiler, one call): ",
                     lambda: identity_group(*args), k_ms))


def phase_route(dev):
    """Windows past the window kernel's 65 535 sites: fused_window_stats
    composes the identity, S and fused_panel_stats, against
    window_stats_plain on the same [2, 512, 65 664] batch (integers exact,
    floats rtol 1e-5, Fst atol 2e-3); the launch counts show the route."""
    import numpy as np
    import torch

    from impop_tpu_torch.ops.windowstat import window_stats, window_stats_plain
    from impop_tpu_torch.stats.panelstats import (_assemble_from_kernel,
                                                  fused_window_stats,
                                                  panel_mask_stack)

    cap_s = 65_664
    rng = np.random.default_rng(41)
    geno, member, smask, panels, lengths = hprc_batch(rng, 2, cap_s=cap_s)
    geno[:, :N_HAP] = np.where(rng.random((2, N_HAP, cap_s)) < 0.02, 1,
                               0).astype(np.int8)
    smask[:] = True
    lengths[:] = 2_000_000.0
    p = panels.shape[1]
    pairs = [(i, j) for i in range(p) for j in range(i + 1, p)]
    pa, pb = tuple(a for a, _ in pairs), tuple(b for _, b in pairs)
    g, m, sm, pn, ln = to_dev(dev, geno, member, smask, panels, lengths)
    sim, pres, s_count, got = fused_window_stats(g, m, sm, ln, pn, pa, pb,
                                                 THRESHOLD, True,
                                                 return_matrices=False)
    torch.cuda.synchronize()
    if sim is not None or pres is not None:
        raise SmokeError("A1: the composed route returned matrices")
    if window_stats.launches:
        raise SmokeError("A1: the window kernel ran past its cap")
    stack, ma, mb = panel_mask_stack(pn, m, pa, pb, True)
    raw = window_stats_plain(g, m, sm, stack, ma, mb, THRESHOLD, ln, pa, pb,
                             True)
    want = _assemble_from_kernel(raw, p + len(pairs), len(pairs), pa, pb,
                                 True)
    if not torch.equal(s_count, raw["s"]):
        raise SmokeError("A1: S differs from the plain version")
    worst = compare_panelstats(got, want, "A1")
    say("A1", f"fused_window_stats [{CAP_N},{cap_s}]x2 (past the window "
        f"kernel's 65 535 sites, S = {[int(x) for x in s_count.tolist()]}): "
        f"composed route equals window_stats_plain (integers exact, floats "
        f"rtol {RTOL}, Fst atol 2e-3; max abs {worst:.3e})")


def phase_degenerate(dev, report):
    """2k: every kernel against its plain version on the degenerate batches
    of ``impop_tpu_torch/bench/degenerate.py`` (a window with no active
    site, a monomorphic one, one with every row missing and one with no
    member at the first, middle and last window; an empty and a
    one-member panel; EHH with no and one carrier of an allele; empty and
    one-hot rows and a window without present pairs for the masked sums;
    zero weights; N = 37, 1000, 1024 and 1152): integers, seeds, gid, sim
    and present exact, float sums rtol 1e-5, NaN in the same places."""
    from impop_tpu_torch.bench import degenerate

    t0 = time.perf_counter()
    done = {}
    for name, case in degenerate.CASES.items():
        try:
            err = degenerate.compare(*degenerate.run_case(name, dev), name)
        except AssertionError as e:
            raise SmokeError(f"2k: {e}") from None
        cases, worst = done.get(case.kernel, (0, 0.0))
        done[case.kernel] = (cases + 1, max(worst, err))
    for kernel, (cases, worst) in done.items():
        entry = report[kernel]
        entry["max_abs_err"] = max(entry.get("max_abs_err", 0.0), worst)
        say("2k", f"{kernel}: {cases} degenerate batches equal to the plain "
            f"version (max abs err {worst:.3e})")
    say("2k", f"{len(degenerate.CASES)} degenerate batches in "
        f"{time.perf_counter() - t0:.1f} s")


# ------------------------------------------------------------------ phase 3


def read_table(path):
    with open(path) as fh:
        lines = [ln.rstrip("\n").split("\t") for ln in fh if ln.strip()]
    return lines[0], lines[1:]


def compare_tables(header, rows_a, rows_b, tag):
    """Same regions; integer columns exact (EHH_FOCAL and EHH_CARR_* too);
    π/D/EHH areas rtol 1e-5; Fst atol 2e-3; NA in the same places."""
    import numpy as np

    if len(rows_a) != len(rows_b):
        raise SmokeError(f"{tag}: {len(rows_a)} vs {len(rows_b)} rows")
    for ra, rb in zip(rows_a, rows_b):
        if ra[:4] != rb[:4]:
            raise SmokeError(f"{tag}: {ra[:4]} vs {rb[:4]}")
        for col, va, vb in zip(header[4:], ra[4:], rb[4:]):
            if (va == "NA") != (vb == "NA"):
                raise SmokeError(f"{tag}: NA mismatch in {col} at {ra[0]}")
            if va == "NA":
                continue
            if col == "EHH_FOCAL" or col.startswith("EHH_CARR"):
                ok = va == vb
            elif col.startswith("FST"):
                ok = abs(float(va) - float(vb)) <= 2e-3
            else:
                ok = bool(np.isclose(float(va), float(vb), rtol=1e-5,
                                     atol=1e-6))
            if not ok:
                raise SmokeError(f"{tag}: {col} at {ra[0]}: {va} vs {vb}")


def simulate_pangenome(tmp):
    """The HPRC-shaped 2 Mb pangenome every scan phase reads: the scan's
    argv prefix, the 20-window BED and the window count."""
    from impop_tpu_torch.hostio import simulate

    ref_len = SCAN_BP
    t0 = time.perf_counter()
    sim = simulate(tmp, ref_len=ref_len, n_haps=N_HAP - 1,
                   site_pool=ref_len // 60, seed=11, span=(0, ref_len))
    bed = os.path.join(tmp, "w.bed")
    with open(bed, "w") as fh:
        for lo in range(0, ref_len, WIN_BP):
            fh.write(f"chr1\t{lo}\t{lo + WIN_BP}\n")
    bed20 = os.path.join(tmp, "w20.bed")
    with open(bed20, "w") as fh:
        for lo in range(0, 20 * WIN_BP, WIN_BP):
            fh.write(f"chr1\t{lo}\t{lo + WIN_BP}\n")
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
    say("3", f"simulated {ref_len / 1e6:g} Mb x {N_HAP} haplotypes in "
        f"{time.perf_counter() - t0:.1f} s")
    base = ["scan", "-b", bed, "--paf", sim.paf_path, "--fasta",
            sim.fasta_path, "-P", "CHM13#0#", *panel_args]
    return {"base": base, "bed20": bed20, "n_win": ref_len // WIN_BP,
            "paf": sim.paf_path, "fasta": sim.fasta_path,
            "panels": panel_args[1::2]}


def run_scan(argv, what):
    from impop_tpu_torch.cli import main as torch_main

    rc = torch_main(argv)
    if rc != 0:
        raise SmokeError(f"{what} exited {rc}")


def same_file(path_a, path_b, what):
    with open(path_a) as fa, open(path_b) as fb:
        if fa.read() != fb.read():
            raise SmokeError(what)


def scan_path(dev, tmp, pg, tag, flags, afs=False, resume=True):
    """``scan <flags>`` over the whole pangenome on the card; the first 20
    windows again on the CPU (and, when it writes a spectrum, on the card,
    so that both spectrum files cover the same windows); then a journal
    resume that must reproduce the table and the spectrum."""
    import numpy as np

    def out(name):
        return os.path.join(tmp, f"{tag}.{name}")

    def afs_args(name):
        return ["--afs", out(name)] if afs else []

    base, n_win = pg["base"] + flags, pg["n_win"]
    base20 = list(base)
    base20[2] = pg["bed20"]
    journal, timing = out("jsonl"), out("timing.json")
    t0 = time.perf_counter()
    run_scan(base + afs_args("gpu.afs") + [
        "--batch", "64", "--journal", journal, "-o", out("gpu.tsv"),
        "--timing-json", timing, "--device", dev.type], f"scan {flags}")
    wall = time.perf_counter() - t0
    header, rows = read_table(out("gpu.tsv"))
    if len(rows) != n_win:
        raise SmokeError(f"{tag}: scan table has {len(rows)} rows, want "
                         f"{n_win}")
    value_cols = [i for i, h in enumerate(header)
                  if h.startswith("PI_") or h.startswith("EHH_AREA")]
    for r in rows:
        for i in value_cols:
            if r[i] == "NA" or not np.isfinite(float(r[i])):
                raise SmokeError(f"{tag}: non-finite {header[i]} at {r[0]}")
    with open(timing) as fh:
        stages = json.load(fh)["stages"]
    brief = ", ".join(f"{k} {v['total_sec']:.3f}s"
                      for k, v in sorted(stages.items(),
                                         key=lambda kv: -kv[1]["total_sec"]))
    say(tag, f"scan {' '.join(flags)} {n_win} windows on {dev}: "
        f"{wall:.2f} s wall, {n_win / wall:.2f} windows/s; stages: {brief}")

    run_scan(base20 + afs_args("cpu20.afs") + [
        "--batch", "20", "-o", out("cpu20.tsv"), "--device", "cpu"],
        "cpu scan")
    _, rows_cpu = read_table(out("cpu20.tsv"))
    compare_tables(header, rows[:20], rows_cpu, f"{tag} gpu-vs-cpu")
    msg = ("first 20 windows: GPU table equals the CPU table (integers "
           "exact, pi/D/EHH areas rtol 1e-5, Fst atol 2e-3)")
    if afs:
        run_scan(base20 + afs_args("gpu20.afs") + [
            "--batch", "20", "-o", out("gpu20.tsv"), "--device", dev.type],
            "gpu 20-window scan")
        same_file(out("gpu20.afs"), out("cpu20.afs"),
                  f"{tag}: GPU and CPU spectrum files differ")
        msg += "; spectrum files identical"
    say(tag, msg)

    if resume:
        run_scan(base + afs_args("resume.afs") + [
            "--journal", journal, "-o", out("resume.tsv"),
            "--device", dev.type], "resume scan")
        same_file(out("gpu.tsv"), out("resume.tsv"),
                  f"{tag}: journal resume changed the table")
        if afs:
            same_file(out("gpu.afs"), out("resume.afs"),
                      f"{tag}: journal resume changed the spectrum")
        say(tag, f"journal resume: identical {n_win}-row table"
            + (" and spectrum" if afs else ""))


def phase_seed_risk(dev, tmp):
    """Partial-coverage tile: the (seed, seed) cross pair has no data, so
    seed_risk fires and FSTG is recomputed exactly (expected 1.0)."""
    import numpy as np

    from impop_tpu_torch.cli import main as torch_main

    genodir = os.path.join(tmp, "genodir")
    os.makedirs(genodir, exist_ok=True)
    geno = np.full((4, 8), -1, np.int8)
    geno[0, :4] = [1, 0, 1, 0]
    geno[1] = [1, 0, 1, 0, 0, 0, 0, 1]
    geno[2, 4:] = [1, 1, 0, 0]
    geno[3] = [0, 1, 1, 0, 1, 1, 0, 0]
    names = np.asarray([f"h{i:02d}#1#c{i}" for i in range(4)])
    np.savez(os.path.join(genodir, "chr1:0-1000.npz"), geno=geno,
             names=names)
    bed = os.path.join(tmp, "risk.bed")
    with open(bed, "w") as fh:
        fh.write("chr1\t0\t1000\n")
    pa, pb = os.path.join(tmp, "A.txt"), os.path.join(tmp, "B.txt")
    with open(pa, "w") as fh:
        fh.write("h00\nh01\n")
    with open(pb, "w") as fh:
        fh.write("h02\nh03\n")
    out = os.path.join(tmp, "risk.tsv")
    if torch_main(["scan", "-b", bed, "-P", "", "--geno-dir", genodir,
                   "--panel", pa, "--panel", pb, "-o", out,
                   "--device", dev.type]) != 0:
        raise SmokeError("seed-risk scan failed")
    header, rows = read_table(out)
    fstg = float(rows[0][header.index("FSTG_A_B")])
    if abs(fstg - 1.0) > 1e-6:
        raise SmokeError(f"exact FSTG {fstg}, want 1.0")
    say("4", f"seed_risk window recomputed exactly: FSTG_A_B = {fstg}")


def compare_tajd(path_a, path_b, tag):
    """REGION .. SEGREGATING_SITES exact, PI and TAJIMAS_D rtol 1e-5."""
    import numpy as np

    header, rows_a = read_table(path_a)
    _, rows_b = read_table(path_b)
    if len(rows_a) != len(rows_b) or not rows_a:
        raise SmokeError(f"{tag}: {len(rows_a)} vs {len(rows_b)} rows")
    for ra, rb in zip(rows_a, rows_b):
        if ra[:4] != rb[:4]:
            raise SmokeError(f"{tag}: {ra[:4]} vs {rb[:4]}")
        for col, va, vb in zip(header[4:], ra[4:], rb[4:]):
            if (va == "NA") != (vb == "NA") or (va != "NA" and not np.isclose(
                    float(va), float(vb), rtol=1e-5, atol=1e-8)):
                raise SmokeError(f"{tag}: {col} at {ra[0]}: {va} vs {vb}")
    return rows_a


def run_cli(argv, what) -> float:
    """One ``impop_tpu_torch.cli`` command; its wall seconds."""
    from impop_tpu_torch.cli import main as torch_main

    t0 = time.perf_counter()
    if torch_main(argv) != 0:
        raise SmokeError(f"{what} failed")
    return time.perf_counter() - t0


def native_extractor(pg):
    from impop_tpu_torch.hostio import _open_extractor

    ex = _open_extractor(pg["paf"], pg["fasta"])
    if type(ex).__name__ != "NativeExtractor":
        raise SmokeError(f"extractor is {type(ex).__name__}, not the native "
                         "one")
    return ex


def write_tiles(ex, spans, directory):
    """Each (lo, hi) of chr1, extracted with the native extractor, as
    ``<directory>/CHM13#0#chr1:lo-hi.npz``; returns the window matrices."""
    import numpy as np

    os.makedirs(directory, exist_ok=True)
    out = []
    for lo, hi in spans:
        wm = ex.extract("CHM13#0#chr1", lo, hi)
        np.savez(os.path.join(directory, f"CHM13#0#chr1:{lo}-{hi}.npz"),
                 geno=wm.geno, names=np.asarray(wm.names),
                 site_keys=np.asarray(wm.site_keys))
        out.append(wm)
    return out


def write_bed(path, spans):
    with open(path, "w") as fh:
        fh.writelines(f"chr1\t{lo}\t{hi}\n" for lo, hi in spans)


def phase_tajd(dev, tmp, pg, step):
    """``tajd`` on allele tiles of the simulated pangenome: ten 200 kb
    windows batched (S >= 2048 per window), then the whole 2 Mb as one
    window, batched and streamed.  ``step`` receives the padded batch of
    the ten windows for :func:`time_tajd_step`."""
    import numpy as np

    t0 = time.perf_counter()
    ex = native_extractor(pg)
    tiles, whole = os.path.join(tmp, "tajd200k"), os.path.join(tmp, "tajd2m")
    win = 200_000
    spans = [(lo, lo + win) for lo in range(0, SCAN_BP, win)]
    bed, bed1 = os.path.join(tmp, "t200k.bed"), os.path.join(tmp, "t2m.bed")
    write_bed(bed, spans)
    write_bed(bed1, [(0, SCAN_BP)])
    wms = write_tiles(ex, spans, tiles) + write_tiles(ex, [(0, SCAN_BP)],
                                                      whole)
    sites = [wm.geno.shape[1] for wm in wms]
    big, big_names = wms[-1].geno, wms[-1].names
    t_extract = time.perf_counter() - t0
    if min(sites[:-1]) < 2048:
        raise SmokeError(f"tajd: a 200 kb window has {min(sites[:-1])} "
                         "sites, below the long-window regime (2048)")
    say("7", f"extracted {len(spans)} windows of 200 kb ({min(sites[:-1])}-"
        f"{max(sites[:-1])} sites x {big.shape[0]} rows) and the whole "
        f"{SCAN_BP / 1e6:g} Mb ({sites[-1]} sites) with the native "
        f"extractor in {t_extract:.2f} s")

    def out(name):
        return os.path.join(tmp, f"tajd.{name}.tsv")

    base = ["tajd", "-b", bed, "-P", "CHM13#0#", "--geno-dir", tiles]
    wall_g = run_cli(base + ["-o", out("gpu"), "--device", dev.type],
                 "tajd on the card")
    wall_c = run_cli(base + ["-o", out("cpu"), "--device", "cpu"],
                     "tajd --cpu")
    rows = compare_tajd(out("gpu"), out("cpu"), "7 gpu-vs-cpu")
    # device batches of 4 windows: the rows of the one-batch run
    import impop_tpu_torch.cli as torch_cli
    from impop_tpu_torch.hostio import _capacity_for

    cap_n = _capacity_for([wm.geno.shape[0] for wm in wms[:-1]])
    saved = torch_cli._WINDOW_CHUNK_ELEMS
    torch_cli._WINDOW_CHUNK_ELEMS = 4 * cap_n * cap_n
    try:
        run_cli(base + ["-o", out("gpu_b4"), "--device", dev.type],
                "tajd in batches of 4 on the card")
    finally:
        torch_cli._WINDOW_CHUNK_ELEMS = saved
    compare_tajd(out("gpu_b4"), out("gpu"), "7 batches of 4 vs one batch")
    with open(out("gpu_b4")) as fa, open(out("gpu")) as fb:
        same_text = fa.read() == fb.read()
    say("7", f"tajd in device batches of 4 + 4 + 2 windows: rows equal to the "
        f"one-batch rows (integers exact, PI and D rtol 1e-5; text "
        f"{'identical' if same_text else 'differs in the last digits'})")
    for r in rows:
        if not np.isfinite(float(r[4])) or r[5] == "NA" or int(r[3]) < 2048:
            raise SmokeError(f"7: implausible row {r}")
    afr = pg["panels"][0]
    run_cli(base + ["-s", afr, "-o", out("gpu_s"), "--device", dev.type],
        "tajd -s on the card")
    run_cli(base + ["-s", afr, "-o", out("cpu_s"), "--device", "cpu"],
        "tajd -s --cpu")
    rows_s = compare_tajd(out("gpu_s"), out("cpu_s"), "7 -s gpu-vs-cpu")
    n_afr = {int(r[2]) for r in rows_s}
    say("7", f"tajd --geno-dir {len(spans)} x 200 kb on {dev}: "
        f"{wall_g:.2f} s wall; on the CPU {wall_c:.2f} s; tables equal "
        f"(integers exact, PI and D rtol 1e-5); -s {os.path.basename(afr)} "
        f"(SAMPLES {sorted(n_afr)}): equal")

    g_list = []
    for lo, hi in spans:
        data = np.load(os.path.join(tiles, f"CHM13#0#chr1:{lo}-{hi}.npz"))
        g_list.append(data["geno"][np.argsort(data["names"])])
    cap_n = _capacity_for([g.shape[0] for g in g_list])
    cap_s = ((max(g.shape[1] for g in g_list) + 127) // 128) * 128
    w = len(g_list)
    geno = np.full((w, cap_n, cap_s), -1, np.int8)
    member = np.zeros((w, cap_n), bool)
    smask = np.zeros((w, cap_s), bool)
    for wi, g in enumerate(g_list):
        geno[wi, :g.shape[0], :g.shape[1]] = g
        member[wi, :g.shape[0]] = True
        smask[wi, :g.shape[1]] = True
    step["batch"] = (geno, member, smask, member[:, None, :].copy(),
                     np.full(w, float(win), np.float32))

    # the whole 2 Mb: batched, then streamed in 4096-site chunks
    npy = os.path.join(tmp, "whole.npy")
    np.save(npy, big)
    names = os.path.join(tmp, "whole.names")
    with open(names, "w") as fh:
        fh.write("\n".join(big_names) + "\n")
    base1 = ["tajd", "-b", bed1, "-P", "CHM13#0#"]
    wall_b = run_cli(base1 + ["--geno-dir", whole, "-o", out("whole_b"),
                          "--device", dev.type], "tajd whole, batched")
    wall_s = run_cli(base1 + ["--stream-npy", npy, "--stream-names", names,
                          "--chunk-sites", "4096", "-o", out("whole_s"),
                          "--device", dev.type], "tajd whole, streamed")
    with open(out("whole_b")) as fb, open(out("whole_s")) as fs:
        row_b, row_s = fb.read(), fs.read()
    if row_b != row_s:
        raise SmokeError(f"7: streamed row differs from the batched one:\n"
                         f"{row_b}{row_s}")
    say("7", f"whole {SCAN_BP / 1e6:g} Mb as one window ({sites[-1]} "
        f"sites): batched {wall_b:.2f} s, streamed in "
        f"{-(-sites[-1] // 4096)} chunks of 4096 {wall_s:.2f} s; rows "
        f"identical: {row_s.splitlines()[1]}")


def time_tajd_step(dev, step):
    """The tajd device step alone on the ten-window batch of phase 7, and
    its identity kernel (CUDA events, outside the counted path)."""
    from impop_tpu_torch.ops.pairdiff import pairwise_identity
    from impop_tpu_torch.parallel.scan import batch_tajd_from_alleles

    args = to_dev(dev, *step["batch"])
    w, cap_n, cap_s = args[0].shape
    step_ms = cuda_time_ms(
        lambda: batch_tajd_from_alleles(*args, THRESHOLD), 5)
    id_ms = cuda_time_ms(lambda: pairwise_identity(*args[:3], args[4]), 5)
    say("7", f"tajd device step [{cap_n},{cap_s}]x{w}: {step_ms:.4f} ms, "
        f"of which pairwise_identity {id_ms:.4f} ms")
    # the seed-peel kernel writes gid: no argmax runs in the step
    say("7", "tajd device step by kernel (torch.profiler, one step; no "
        "argmax kernel): " + profile_ops(
            lambda: batch_tajd_from_alleles(*args, THRESHOLD), step_ms,
            absent=("argmax",)))


def profile_ops(fn, step_ms: float, top: int = 8, absent=()) -> str:
    """Device time of one call of fn (after a warm-up) by kernel: only the
    events the profiler traced on the card count (an operator's row
    repeats the time of the kernels it launched), and their sum against
    ``step_ms`` gives the card's idle share of the step.  Fails if a
    kernel's name contains a word of ``absent``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us, e.key, e.count))
    if not rows:
        return "no device time recorded"
    for _, key, _ in rows:
        if any(word in key.lower() for word in absent):
            raise SmokeError(f"the profile lists {key}")
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e3
    idle = 100.0 * (1.0 - busy / step_ms)
    return (f"kernels and copies {busy:.4f} ms, {idle:.1f}% idle of "
            f"{step_ms:.4f} ms; " + ", ".join(
                f"{key[:60]} {us / 1e3:.4f} ms x{n}"
                for us, key, n in rows[:top]))


def compare_panelstats(got, want, tag) -> float:
    """Integer fields exact, Fst / Da atol 2e-3 with NaN at the same
    places, other floats rtol RTOL; returns the max abs difference."""
    import torch

    worst = 0.0

    def check(name, a, b):
        nonlocal worst
        if name in ("n", "num_groups", "pairs_used", "pairs_missing",
                    "seed_risk"):
            if not torch.equal(a, b):
                raise SmokeError(f"{tag}: {name} differs")
            return
        diff = torch.nan_to_num((a - b).abs(), nan=0.0)
        worst = max(worst, float(diff.max()))
        if name.endswith((".fst", ".da")):
            ok = (diff <= 2e-3) & (a.isnan() == b.isnan())
        else:
            ok = torch.isclose(a, b, rtol=RTOL, atol=ATOL, equal_nan=True)
        if not bool(ok.all()):
            raise SmokeError(f"{tag}: {name} beyond tolerance")

    for f, a, b in zip(got._fields, got, want):
        if isinstance(a, tuple):
            for f2, a2, b2 in zip(a._fields, a, b):
                check(f"{f}.{f2}", a2, b2)
        else:
            check(f, a, b)
    return worst


def phase_matrices(dev):
    """fused_window_stats with and without its matrices on one batch."""
    import numpy as np
    import torch

    from impop_tpu_torch.stats.panelstats import fused_window_stats

    rng = np.random.default_rng(37)
    geno, member, smask, panels, lengths = hprc_batch(rng, BATCH)
    p = panels.shape[1]
    pairs = [(i, j) for i in range(p) for j in range(i + 1, p)]
    pa, pb = tuple(a for a, _ in pairs), tuple(b for _, b in pairs)
    g, m, sm, pn, ln = to_dev(dev, geno, member, smask, panels, lengths)
    sim, pres, s_m, res_m = fused_window_stats(g, m, sm, ln, pn, pa, pb,
                                               THRESHOLD, True)
    _, _, s_w, res_w = fused_window_stats(g, m, sm, ln, pn, pa, pb,
                                          THRESHOLD, True,
                                          return_matrices=False)
    torch.cuda.synchronize()
    if tuple(sim.shape) != (BATCH, CAP_N, CAP_N) or pres.dtype != torch.bool:
        raise SmokeError(f"8: matrices of shape {tuple(sim.shape)}")
    if not torch.equal(s_m, s_w):
        raise SmokeError("8: S differs with and without matrices")
    if not bool(torch.isfinite(res_m.pi).all()):
        raise SmokeError("8: non-finite pi")
    worst = compare_panelstats(res_m, res_w, "8")
    say("8", f"fused_window_stats(return_matrices=True) [{CAP_N},{CAP_S}]x"
        f"{BATCH}: sim [{CAP_N},{CAP_N}] per window; S and integer fields "
        f"exact, floats within rtol {RTOL} (Fst atol 2e-3) of "
        f"return_matrices=False (max abs {worst:.3e})")


# ------------------------------------------------------------------ phase 9

STAT_FLOATS = ("PI", "PI_A", "PI_B", "PI_C", "PI_XY", "PI_AB_AVG", "DXY",
               "PICA_OUTPUT", "TAJIMAS_D")
STAT_WINDOWS = 200


def compare_stat_tables(path_a, path_b, tag, rows=20):
    """A per-statistic table on the card (its first ``rows`` rows) against
    the CPU's: integer and text columns exact; π, PI_*, DXY, PICA_OUTPUT
    and TAJIMAS_D rtol 1e-5; FST and DA atol 2e-3; NA at the same places.
    Returns the card's rows."""
    import numpy as np

    header, rows_a = read_table(path_a)
    header_b, rows_b = read_table(path_b)
    if header != header_b or len(rows_a[:rows]) != len(rows_b) or not rows_b:
        raise SmokeError(f"{tag}: tables differ in shape")
    for ra, rb in zip(rows_a[:rows], rows_b):
        for col, va, vb in zip(header, ra, rb):
            if (va == "NA") != (vb == "NA"):
                raise SmokeError(f"{tag}: NA mismatch in {col} at {ra[0]}")
            if va == "NA":
                continue
            if col == "PICA_OUTPUT":
                (va, sa), (vb, sb) = va.split(" ", 1), vb.split(" ", 1)
                if sa != sb:
                    raise SmokeError(f"{tag}: {col} at {ra[0]}: {sa} vs {sb}")
            if col in ("FST", "DA"):
                ok = abs(float(va) - float(vb)) <= 2e-3
            elif col in STAT_FLOATS:
                ok = bool(np.isclose(float(va), float(vb), rtol=1e-5,
                                     atol=1e-8))
            else:
                ok = va == vb
            if not ok:
                raise SmokeError(f"{tag}: {col} at {ra[0]}: {va} vs {vb}")
    return rows_a


def phase_stats(dev, tmp, pg, step):
    """The per-statistic commands on 200 consecutive 5 kb windows of the
    simulated pangenome as allele tiles, on the card; each again on the
    first 20 windows on the CPU.  ``step`` receives the card's EUR / AFR
    batch of the 200 windows for :func:`time_stats_step`."""
    import numpy as np

    from impop_tpu_torch.cli import GenoSimSource
    from impop_tpu_torch.hostio import (_capacity_for, read_panel_file,
                                        write_similarity_tsv)
    from impop_tpu_torch.runtime.batcher import PanelSet, build_window_batch

    t0 = time.perf_counter()
    spans = [(lo, lo + WIN_BP)
             for lo in range(0, STAT_WINDOWS * WIN_BP, WIN_BP)]
    tiles = os.path.join(tmp, "stat_tiles")
    wms = write_tiles(native_extractor(pg), spans, tiles)
    bed, bed20 = os.path.join(tmp, "s200.bed"), pg["bed20"]
    write_bed(bed, spans)
    meta = os.path.join(tmp, "metadata")
    os.makedirs(meta)
    for path in pg["panels"]:
        shutil.copy(path, meta)
    sites = [wm.geno.shape[1] for wm in wms]
    say("9", f"extracted {STAT_WINDOWS} windows of {WIN_BP} bp "
        f"({min(sites)}-{max(sites)} sites, mean {np.mean(sites):.1f}, x "
        f"{wms[0].geno.shape[0]} rows) in {time.perf_counter() - t0:.2f} s")

    def panel(name):
        return os.path.join(meta, f"agc.{name}")

    pair = ["-A", panel("EUR"), "-B", panel("AFR")]
    tile_src = ["--geno-dir", tiles]

    def check(tag, argv, on_card_bed=bed, outputs=None):
        """argv over ``on_card_bed`` on the card and over the first 20
        windows on the CPU; tables compared, walls reported.  ``outputs``:
        the tables a panels command writes into its working directory."""
        walls, tables = {}, {}
        for where, dev_name, bed_path in (("gpu", dev.type, on_card_bed),
                                          ("cpu", "cpu", bed20)):
            out = os.path.join(tmp, f"stat.{tag}.{where}")
            args = [argv[0], "-b", bed_path] + argv[1:] + [
                "--device", dev_name]
            if outputs is None:
                tables[where] = [out + ".tsv"]
                walls[where] = run_cli(args + ["-o", out + ".tsv"], tag)
                continue
            tables[where] = [os.path.join(out, name) for name in outputs]
            os.makedirs(out)
            cwd = os.getcwd()
            os.chdir(out)
            try:
                walls[where] = run_cli(args, tag)
            finally:
                os.chdir(cwd)
        for a, b in zip(tables["gpu"], tables["cpu"]):
            rows = compare_stat_tables(a, b, f"9 {tag} "
                                       f"{os.path.basename(a)}")
        say("9", f"{tag}: {len(rows)} windows x {len(tables['gpu'])} "
            f"table(s) on {dev} in {walls['gpu']:.2f} s wall; the first 20 "
            f"on the CPU {walls['cpu']:.2f} s; tables agree (integers "
            "exact, pi/Dxy rtol 1e-5, Fst/Da atol 2e-3, NA in the same "
            "places)")
        return rows

    rows = check("pi", ["pi", *tile_src, "-u", panel("EUR")])
    pis = [float(r[-1].split()[0]) for r in rows]
    if len(rows) != STAT_WINDOWS or not all(np.isfinite(pis)) \
            or max(pis) <= 0:
        raise SmokeError(f"9 pi: implausible table ({len(rows)} rows)")
    # -r rounds on the host and launches nothing: 20 windows are enough
    check("pi -r 5", ["pi", *tile_src, "-u", panel("EUR"), "-r", "5"],
          on_card_bed=bed20)
    check("hfst", ["hfst", *tile_src, *pair])
    check("hud grouped", ["hud", *tile_src, "-m", "grouped", *pair])
    rows = check("fst3pi", ["fst3pi", *tile_src, *pair])
    if all(r[-1] == "NA" for r in rows):
        raise SmokeError("9 fst3pi: every FST is NA")
    pairs = [f"{a.lower()}.{b.lower()}.fst" for a, b in (
        ("EUR", "AFR"), ("EAS", "AFR"), ("SAS", "AFR"), ("AMR", "AFR"),
        ("EAS", "EUR"), ("SAS", "EUR"), ("AMR", "EUR"), ("EAS", "SAS"),
        ("AMR", "SAS"), ("AMR", "EAS"))]
    # ten hfst runs, each reloading its windows: 20 of them on the card
    check("panels-hfst", ["panels-hfst", *tile_src, "--metadata-dir", meta],
          on_card_bed=bed20, outputs=pairs)
    check("panels-tajd", ["panels-tajd", *tile_src, "--metadata-dir", meta],
          outputs=["eur.tj", "afr.tj", "eas.tj", "sas.tj", "amr.tj"])

    # the --sim-dir path: 20 windows as similarity TSVs
    t0 = time.perf_counter()
    simdir = os.path.join(tmp, "stat_sims")
    os.makedirs(simdir)
    src = GenoSimSource(None, geno_dir=tiles, device="cpu")
    for lo, hi in spans[:20]:
        region = f"CHM13#0#chr1:{lo}-{hi}"
        write_similarity_tsv(src.load(region),
                             os.path.join(simdir, f"{region}.sim"))
    say("9", f"wrote 20 similarity TSVs in {time.perf_counter() - t0:.2f} s")
    check("pi --sim-dir", ["pi", "--sim-dir", simdir], on_card_bed=bed20)
    check("hud direct --sim-dir", ["hud", "--sim-dir", simdir, "-m",
                                   "direct", *pair], on_card_bed=bed20)
    one = os.path.join(simdir, "CHM13#0#chr1:0-5000.sim")
    walls = {}
    for where, dev_name in (("gpu", dev.type), ("cpu", "cpu")):
        walls[where] = run_cli(
            ["afs", "--input", one, "--output",
             os.path.join(tmp, f"afs.{where}.tsv"), "--details",
             os.path.join(tmp, f"afs.{where}.details"), "--device",
             dev_name], f"afs on {dev_name}")
    for ext in ("tsv", "details"):
        same_file(os.path.join(tmp, f"afs.gpu.{ext}"),
                  os.path.join(tmp, f"afs.cpu.{ext}"),
                  f"9 afs: the {ext} files differ")
    _, clusters = read_table(os.path.join(tmp, "afs.gpu.tsv"))
    say("9", f"afs --input (one window): {len(clusters)} allele classes on "
        f"{dev} in {walls['gpu']:.2f} s, on the CPU {walls['cpu']:.2f} s; "
        "table and details identical")

    mats = [GenoSimSource(None, geno_dir=tiles, device=dev).load(
        f"CHM13#0#chr1:{lo}-{hi}") for lo, hi in spans]
    panels = PanelSet.from_dict({"A": read_panel_file(panel("EUR")),
                                 "B": read_panel_file(panel("AFR"))})
    step["stats"] = build_window_batch(
        mats, panels, _capacity_for([m.n for m in mats]), device=dev)[0]


def time_stats_step(dev, step):
    """The per-statistic device steps alone on the 200-window EUR / AFR
    batch of phase 9 (CUDA events and torch.profiler, outside the counted
    path)."""
    from impop_tpu_torch.parallel.scan import batch_hudson, batch_pi_panels

    b = step["stats"]
    w, n = b.sim.shape[0], b.sim.shape[-1]
    steps = {
        "batch_pi_panels": lambda: batch_pi_panels(*b, THRESHOLD),
        "batch_hudson direct": lambda: batch_hudson(
            *b, (0,), (1,), THRESHOLD, with_grouped=False),
        "batch_hudson grouped": lambda: batch_hudson(*b, (0,), (1,),
                                                     THRESHOLD),
    }
    for name, fn in steps.items():
        ms = cuda_time_ms(fn, 5)
        say("9", f"{name} [{n},{n}]x{w}, panels EUR / AFR: {ms:.4f} ms "
            f"(CUDA events, median of 5); by kernel (torch.profiler): "
            + profile_ops(fn, ms))


# ------------------------------------------------------------------ B1

EHH_SITES = 20_250            # 40 windows of 500 sites and a tail of 250
EHH_W, EHH_P = 500, 250       # ehh -w, -p
EHH_FOCALS = 50


def read_rows(path):
    with open(path) as fh:
        return [ln.split() for ln in fh if ln.strip()]


def compare_ehh_rows(path_a, path_b, tag):
    """Two ``ehh`` outputs: the same rows with every field but the area
    equal, areas finite and within rtol 1e-6.  Returns the first's rows."""
    import math

    a, b = read_rows(path_a), read_rows(path_b)
    if len(a) != len(b) or not a:
        raise SmokeError(f"{tag}: {len(a)} vs {len(b)} rows")
    for ra, rb in zip(a, b):
        va, vb = float(ra[-1]), float(rb[-1])
        if ra[:-1] != rb[:-1] or not math.isfinite(va) \
                or abs(va - vb) > 1e-6 * abs(vb):
            raise SmokeError(f"{tag}: {ra} vs {rb}")
    return a


def phase_ehh_sfs(dev, tmp, pg, step, smi):
    """``ehh`` and ``sfs`` on the simulated pangenome as 400 allele tiles
    of 5 kb, and ``spectrum --no-plots`` / ``makewindows``.  ``ehh``
    matrix mode reads the tiles' alt calls side by side (466 x 20 250, -p
    250 -w 500: 40 windows and a ragged tail of 250 sites, in device
    batches of 2^25 cells and of 8 windows), extraction mode 50 focals
    spread over the 400 tiles; each on the card and on the CPU.  ``step``
    receives the matrix run's windows for :func:`time_ehh_batch`."""
    import numpy as np

    import impop_tpu_torch.cli as torch_cli
    from impop_tpu_torch.ops.ehhdeath import ehh_area

    t0 = time.perf_counter()
    spans = [(lo, lo + WIN_BP) for lo in range(0, SCAN_BP, WIN_BP)]
    tiles = os.path.join(tmp, "b1_tiles")
    wms = write_tiles(native_extractor(pg), spans, tiles)
    bed = os.path.join(tmp, "b1.bed")
    write_bed(bed, spans)
    if len({wm.geno.shape[0] for wm in wms}) != 1:
        raise SmokeError("B1: the tiles hold different haplotype counts")
    whole = np.concatenate([(wm.geno[np.argsort(wm.names)] == 1)
                            .astype(np.int8) for wm in wms], axis=1)
    if whole.shape[1] < EHH_SITES:
        raise SmokeError(f"B1: {whole.shape[1]} sites, below {EHH_SITES}")
    whole = whole[:, :EHH_SITES]
    mat = os.path.join(tmp, "b1_matrix.txt")
    np.savetxt(mat, whole, fmt="%d")
    say("B1", f"{len(spans)} tiles of {WIN_BP} bp and a {whole.shape[0]} x "
        f"{whole.shape[1]} alt matrix written in "
        f"{time.perf_counter() - t0:.2f} s")

    def out(name):
        return os.path.join(tmp, f"b1.{name}")

    walls = []
    n_win = -(-EHH_SITES // EHH_W)
    tail = (str((n_win - 1) * EHH_W), str(EHH_SITES))
    matrix = ["ehh", "-i", mat, "-p", str(EHH_P), "-w", str(EHH_W)]
    for compat in (False, True):
        tag = "ehh --compat-ehhgfa" if compat else "ehh"
        argv = matrix + (["--compat-ehhgfa"] if compat else [])
        before = ehh_area.launches
        wall_g = run_cli(argv + ["-o", out(f"{compat}.gpu"), "--device",
                                 dev.type], f"{tag} on the card")
        launches = ehh_area.launches - before
        wall_c = run_cli(argv + ["-o", out(f"{compat}.cpu"), "--device",
                                 "cpu"], f"{tag} --device cpu")
        rows = compare_ehh_rows(out(f"{compat}.gpu"), out(f"{compat}.cpu"),
                                f"B1 {tag}")
        if {int(r[0]) for r in rows} != set(range(1, n_win + 1)) \
                or tuple(rows[-1][1:3]) != tail:
            raise SmokeError(f"B1 {tag}: windows {rows[0][:3]} .. "
                             f"{rows[-1][:3]}, not {n_win} ending at "
                             f"{EHH_SITES}")
        walls.append(f"{tag} {wall_g:.2f} s on the card ({launches} "
                     f"launches), {wall_c:.2f} s on the CPU")
    # device batches of 8 windows: the text of the one-batch run
    saved = torch_cli._WINDOW_CHUNK_ELEMS
    torch_cli._WINDOW_CHUNK_ELEMS = 8 * whole.shape[0] * EHH_W
    try:
        before = ehh_area.launches
        wall_b = run_cli(matrix + ["-o", out("b8.gpu"), "--device",
                                   dev.type],
                         "ehh in batches of 8 on the card")
        launches = ehh_area.launches - before
    finally:
        torch_cli._WINDOW_CHUNK_ELEMS = saved
    same_file(out("b8.gpu"), out("False.gpu"),
              "B1 ehh: batches of 8 windows differ from one batch")
    if launches != -(-n_win // 8):
        raise SmokeError(f"B1 ehh in batches of 8: {launches} launches, "
                         f"not {-(-n_win // 8)}")
    say("B1", f"ehh -p {EHH_P} -w {EHH_W} on {whole.shape[0]} x "
        f"{EHH_SITES} ({n_win} windows, the last of "
        f"{EHH_SITES - int(tail[0])} sites): " + "; ".join(walls)
        + f"; rows equal (fields exact, areas rtol 1e-6); in {launches} "
        f"device batches of 8 windows {wall_b:.2f} s, text identical to "
        f"one batch [{smi}]")
    step["ehh"] = whole

    # extraction mode: 50 focals over the 400 tiles, then one alone
    picks = np.linspace(0, len(spans) - 1, EHH_FOCALS).astype(int)
    focals = [str(spans[k][0] + WIN_BP // 2) for k in picks]
    base = ["ehh", "--geno-dir", tiles, "-b", bed, "-P", "CHM13#0#"]
    for fp in focals:
        base += ["--focal", fp]
    wall_g = run_cli(base + ["-o", out("x.gpu"), "--device", dev.type],
                     "ehh --geno-dir on the card")
    wall_c = run_cli(base + ["-o", out("x.cpu"), "--device", "cpu"],
                     "ehh --geno-dir --device cpu")
    rows = compare_ehh_rows(out("x.gpu"), out("x.cpu"), "B1 ehh --geno-dir")
    if {r[1] for r in rows} != set(focals):
        raise SmokeError("B1 ehh --geno-dir: a focal has no row")
    alone = focals[EHH_FOCALS // 3]
    run_cli(["ehh", "--geno-dir", tiles, "-b", bed, "-P", "CHM13#0#",
             "--focal", alone, "-o", out("x1.gpu"), "--device", dev.type],
            "ehh --geno-dir, one focal")
    want = [r for r in rows if r[1] == alone]
    if read_rows(out("x1.gpu")) != want:
        raise SmokeError(f"B1 ehh --geno-dir: focal {alone} alone gives "
                         f"{read_rows(out('x1.gpu'))}, in the run of "
                         f"{EHH_FOCALS} {want}")
    say("B1", f"ehh --geno-dir, {EHH_FOCALS} focals over {len(spans)} "
        f"tiles: {len(rows)} rows, {wall_g:.2f} s on the card, "
        f"{wall_c:.2f} s on the CPU, rows equal; focal {alone} alone: "
        f"the same rows as in the run of {EHH_FOCALS} [{smi}]")

    # sfs: five panels, folded and unfolded, with --per-window; the
    # command's capacities give the cells of a batch of 7 windows
    from impop_tpu_torch.hostio import _capacity_for

    panels = [x for p in pg["panels"] for x in ("--panel", p)]
    cells = len(pg["panels"]) * _capacity_for(
        [wm.geno.shape[0] for wm in wms]) * max(
        8, -(-max(wm.geno.shape[1] for wm in wms) // 128) * 128)
    walls = []
    for unfolded in (False, True):
        tag = "sfs --unfolded" if unfolded else "sfs"
        argv = ["sfs", "-b", bed, "--geno-dir", tiles, "-P", "CHM13#0#",
                *panels] + (["--unfolded"] if unfolded else [])
        runs = (("gpu", dev.type, saved), ("cpu", "cpu", saved),
                ("one", dev.type, 1 << 40), ("b7", dev.type, None))
        for name, dev_name, elems in runs:
            torch_cli._WINDOW_CHUNK_ELEMS = elems or 7 * cells
            try:
                wall = run_cli(argv + ["-o", out(f"{tag}.{name}"),
                                       "--per-window",
                                       out(f"{tag}.{name}.pw"), "--device",
                                       dev_name], f"{tag} ({name})")
            finally:
                torch_cli._WINDOW_CHUNK_ELEMS = saved
            if name in ("gpu", "cpu"):
                where = "the card" if name == "gpu" else "the CPU"
                walls.append(f"{tag} {wall:.2f} s on {where}")
            for ext in ("", ".pw"):
                same_file(out(f"{tag}.{name}{ext}"), out(f"{tag}.gpu{ext}"),
                          f"B1 {tag}: the {name} run's file{ext} differs")
        if len(read_rows(out(f"{tag}.gpu"))) < 3:
            raise SmokeError(f"B1 {tag}: empty spectrum")
    say("B1", f"sfs on {len(spans)} tiles, 5 panels, folded and unfolded: "
        + "; ".join(walls) + "; table and --per-window identical on the "
        f"card, the CPU, one device batch and batches of 7 windows [{smi}]")

    # the host commands run where the card is (no matplotlib needed)
    sites = os.path.join(tmp, "b1_sites.tsv")
    with open(sites, "w") as fh:
        fh.write("\t".join(["sample", "chrom", "hap"]
                           + [f"s{k}" for k in range(40)]) + "\n")
        for i, row in enumerate(whole[:, :40]):
            fh.write("\t".join([f"h{i}", "chr1", "1"]
                               + [str(v) for v in row]) + "\n")
    run_cli(["spectrum", "--input", sites, "--no-plots", "-o",
             out("spectrum")], "spectrum --no-plots")
    run_cli(["makewindows", "--region", f"chr1:0:{SCAN_BP}", "-w",
             str(WIN_BP), "-o", out("windows.bed")], "makewindows")
    if read_rows(out("windows.bed")) != read_rows(bed):
        raise SmokeError(f"B1 makewindows: not the {len(spans)} windows")
    say("B1", f"spectrum --no-plots ({len(read_rows(out('spectrum'))) - 1} "
        f"rows) and makewindows (the {len(spans)} windows) ran")


def time_ehh_batch(dev, step, smi):
    """The EHH kernel at the shape of the matrix run's one device batch
    (41 windows of [466, 500]; in compat mode [466, 501] tiles
    [R | focal | R]), by CUDA graph replays and with host time by CUDA
    events, and the whole ``ehh_area_batch`` call (outside the counted
    path)."""
    import numpy as np
    import torch

    from impop_tpu_torch.ops.ehhdeath import ehh_area
    from impop_tpu_torch.stats.ehh import ehh_area_batch, ehh_batch_tiles

    whole = step["ehh"]
    n, total = whole.shape
    starts = range(0, total, EHH_W)
    geno = np.zeros((len(starts), n, EHH_W), np.int8)
    smask = np.zeros((len(starts), EHH_W), bool)
    for row, cs in enumerate(starts):
        part = whole[:, cs:cs + EHH_W]
        geno[row, :, :part.shape[1]] = part
        smask[row, :part.shape[1]] = True
    g, sm = torch.from_numpy(geno).to(dev), torch.from_numpy(smask).to(dev)
    m = torch.ones((len(starts), n), dtype=torch.bool, device=dev)
    for compat in (False, True):
        args = ehh_batch_tiles(g, m, sm, EHH_P - 1, compat)
        k_ms = graph_ms(lambda: ehh_area(*args), 10)
        ev_ms = cuda_time_ms(lambda: ehh_area(*args), 10)
        b_ms = cuda_time_ms(lambda: ehh_area_batch(
            g, m, sm, EHH_P - 1, compat_right_for_left=compat), 10)
        sums, carr = ehh_area(*args)
        c = carr.double()
        # two walks per pair: right and left of the focal
        b_ms_min, by = bound(nbytes(*args, sums, carr),
                             int32=float((c * (c - 1)).sum()))
        say("B1", f"ehh_area at the ehh run's batch "
            f"[{n},{args[0].shape[-1]}]x{args[0].shape[0]}"
            f"{' (compat)' if compat else ''}: {k_ms:.4f} ms on the card "
            f"(CUDA graph replays), {ev_ms:.4f} ms with the wrapper (CUDA "
            f"events), ehh_area_batch {b_ms:.4f} ms; bound "
            f"{b_ms_min:.4f} ms ({by}) [{smi}]")


# ------------------------------------------------------------------ C1

C1_WINDOWS = 320              # one packed scan batch
C1_DEAL_BATCH = 80            # four dealt batches of the same windows
C1_ENTRIES = (1, 2, 4, 4, 2, 1, 1, 2, 4)   # entries of cuda:0, in turns
C1_DEALT_TIMED = 4            # whole batches a timed call of the dealt step
PAIR_N, PAIR_S, PAIR_Q = 2048, 128, 10
PAIR_W = 16                   # windows of one batched pair-shard call
PAIR_CLI_ROWS = 1200          # above --pair-shard auto's 1024
LONG_W, LONG_S = 8, 8192


def compare_scan_rows(got, want, lay, tag) -> bool:
    """Packed scan rows: S, n, seed_risk, EHH carriers and AFS bins equal;
    π, D and EHH areas rtol 1e-5; Fst columns atol 2e-3; NaN at the same
    places.  Returns whether the rows are bitwise equal."""
    import numpy as np

    g, w = got.cpu().numpy(), want.cpu().numpy()
    if g.shape != w.shape:
        raise SmokeError(f"{tag}: rows {g.shape} vs {w.shape}")
    if not np.array_equal(np.isnan(g), np.isnan(w)):
        raise SmokeError(f"{tag}: NaN at other places")
    e, a = lay["ehh"], lay["afs"]
    exact = [lay["s"], lay["n"], lay["risk"], *range(e + 2, a),
             *range(a, g.shape[1])]
    rel = [*range(lay["pi"], lay["fst"]), *range(e, min(e + 2, a))]
    fst = list(range(lay["fst"], lay["s"]))
    ok = np.isfinite(w)
    checks = (
        ("integer columns", np.array_equal(g[:, exact], w[:, exact])),
        ("pi / D / EHH areas", np.allclose(g[:, rel][ok[:, rel]],
                                           w[:, rel][ok[:, rel]],
                                           rtol=1e-5, atol=1e-6)),
        ("Fst", np.allclose(g[:, fst][ok[:, fst]], w[:, fst][ok[:, fst]],
                            rtol=0.0, atol=2e-3)))
    for what, good in checks:
        if not good:
            raise SmokeError(f"{tag}: {what} differ")
    return bool(np.array_equal(np.nan_to_num(g, nan=7.0),
                               np.nan_to_num(w, nan=7.0)))


def c1_one_batch(tag, flat, args, step):
    """The 320-window batch the scan stepped, stepped again under the sync
    debug mode "error" (no call of ``scan_step`` waits for the card), its
    rows against the first step's; then the exact FSTG recompute
    (``scan_step_fstg_exact``) of windows across the batch in one call
    against each window's own call, its identity kernel counted over the
    one call.  Returns the line's text."""
    import numpy as np
    import torch

    from impop_tpu_torch import scanstep
    from impop_tpu_torch.ops.pairdiff import (pairwise_identity,
                                              pairwise_identity_weighted)

    w = flat.shape[0]
    lay = scanstep.row_layout(args[2], len(args[3]), args[7])
    one = scanstep.scan_step(flat, *args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = scanstep.scan_step(flat, *args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    same = compare_scan_rows(again, one, lay, f"C1 {tag} no-sync step")
    rows = [0, w // 4 - 1, w // 4, w // 2 + 1, 3 * w // 4 + 2, w - 1]
    kw = dict(use_weights=args[6], use_ehh=args[7])
    ident = pairwise_identity_weighted if args[6] else pairwise_identity
    before = ident.launches
    got_x = scanstep.scan_step_fstg_exact(flat, *args[:5], rows=rows, **kw)
    ident_launches = ident.launches - before
    if ident_launches == 0:
        raise SmokeError(f"C1 {tag}: the exact recompute launched no "
                         f"{ident.__name__}")
    want_x = torch.cat([scanstep.scan_step_fstg_exact(
        flat, *args[:5], rows=[r], **kw) for r in rows])
    gx, wx = got_x.cpu().numpy(), want_x.cpu().numpy()
    if gx.shape != wx.shape or not np.array_equal(gx, wx, equal_nan=True):
        raise SmokeError(f"C1 {tag}: exact FSTG of rows {rows} in one call "
                         "differs from each row's own call")
    step.setdefault("c1_scan", []).append((tag, flat, args, w))
    return (f"the step again under the sync debug mode \"error\": no "
            f"synchronising call, rows equal the first step's (bitwise "
            f"{'yes' if same else 'no'}); exact FSTG of windows {rows} in "
            f"one call equals each window's own call bitwise, "
            f"{ident.__name__} launched {ident_launches} times by it")


class DealSpy:
    """``process_devices`` patched to k entries of cuda:0 (distinct
    ``torch.device`` objects); records the entry of every dealt batch, its
    host batch, the current stream of the dealing thread and of the step,
    and every stepped wire."""

    def __init__(self, dev, k):
        import torch

        from impop_tpu_torch import scanstep
        from impop_tpu_torch.parallel import distributed

        self.modules = (scanstep, distributed)
        self.entries = [torch.device(dev.type, dev.index) for _ in range(k)]
        self.dealt, self.stepped = [], []
        self.real = (scanstep.deal_wire, scanstep.scan_step,
                     distributed.process_devices)

    def __enter__(self):
        import torch

        scanstep, distributed = self.modules
        real_deal, real_step, _ = self.real

        def deal(flat, entry):
            wire = real_deal(flat, entry)
            index = next(i for i, e in enumerate(self.entries) if e is entry)
            self.dealt.append((index, flat, wire,
                               torch.cuda.current_stream(entry)))
            return wire

        def step(flat, *args):
            self.stepped.append((flat, args,
                                 torch.cuda.current_stream(flat.device)))
            return real_step(flat, *args)

        scanstep.deal_wire, scanstep.scan_step = deal, step
        distributed.process_devices = lambda name: self.entries
        return self

    def __exit__(self, *exc):
        scanstep, distributed = self.modules
        (scanstep.deal_wire, scanstep.scan_step,
         distributed.process_devices) = self.real

    def check(self, tag, n_batches):
        k = len(self.entries)
        got = [i for i, *_ in self.dealt]
        if got != [j % k for j in range(n_batches)]:
            raise SmokeError(f"C1 {tag} x {k}: batches dealt to entries "
                             f"{got}")
        if len(self.stepped) != n_batches or any(
                flat is not wire for (_, _, wire, _), (flat, *_) in zip(
                    self.dealt, self.stepped)):
            raise SmokeError(f"C1 {tag} x {k}: {len(self.stepped)} steps, "
                             "not one on each dealt batch")
        if any(s_deal != s_step for (*_, s_deal), (*_, s_step) in zip(
                self.dealt, self.stepped)):
            raise SmokeError(f"C1 {tag} x {k}: the copy and the step ran "
                             "on different streams")


def c1_scan(dev, tmp, pg, step):
    """``scan`` over the first 320 windows (plain, then ``--identity-mode
    columns --ehh --afs``): once as one device batch, whose batch
    :func:`c1_one_batch` steps again; then dealt in four batches of 80 to
    [cuda:0] x 1, 2 and 4, three times in turns, through
    ``process_devices``: batch j
    on entry j mod k, one step on each, the copy and the step on one
    stream, table, journal and spectrum byte-equal at every k, three
    scans at each k in turns; the dealt batches once more under the sync
    debug mode "error" (copy, step and the copy of the rows back).  ``step`` receives the batches for
    :func:`time_multidevice`."""
    import torch

    from impop_tpu_torch import scanstep
    from impop_tpu_torch.device import on_device

    bed = os.path.join(tmp, "c1.bed")
    write_bed(bed, [(lo, lo + WIN_BP)
                    for lo in range(0, C1_WINDOWS * WIN_BP, WIN_BP)])
    base = list(pg["base"])
    base[2] = bed
    for ti, (tag, flags) in enumerate((
            ("plain", []),
            ("columns --ehh --afs", ["--identity-mode", "columns",
                                     "--ehh"]))):
        afs = ["--afs", os.path.join(tmp, "c1.afs")] if flags else []
        with DealSpy(dev, 1) as spy:
            t0 = time.perf_counter()
            run_scan(base + flags + afs + [
                "--batch", str(C1_WINDOWS), "-o", os.path.join(tmp, "c1.tsv"),
                "--device", dev.type], f"C1 scan {tag}")
            wall = time.perf_counter() - t0
        spy.check(tag, 1)
        flat, args, _ = spy.stepped[0]
        batch_text = c1_one_batch(tag, flat, args, step)

        walls, outputs, spies = [], [], {}
        for k in C1_ENTRIES:
            out = os.path.join(tmp, f"c1.{ti}.deal{len(walls)}")
            extra = ["--afs", out + ".afs"] if flags else []
            with DealSpy(dev, k) as spy:
                t0 = time.perf_counter()
                run_scan(base + flags + extra + [
                    "--batch", str(C1_DEAL_BATCH), "-o", out + ".tsv",
                    "--journal", out + ".jsonl", "--device", dev.type],
                    f"C1 dealt scan {tag} x {k}")
                walls.append(time.perf_counter() - t0)
            spy.check(tag, C1_WINDOWS // C1_DEAL_BATCH)
            spies[k] = spy
            outputs.append([out + ext for ext in (".tsv", ".jsonl")
                            + ((".afs",) if flags else ())])
        for got in outputs[1:]:
            for path_a, path_b in zip(outputs[0], got):
                same_file(path_a, path_b, f"C1 dealt scan {tag}: "
                          f"{os.path.basename(path_b)} differs from "
                          f"{os.path.basename(path_a)}")
        # the batches dealt to [cuda:0] x 4 under the sync debug mode: no
        # call of the copy, the step or the copy back waits for the card
        spy = spies[4]
        want = [scanstep.scan_step(wire, *a) for wire, a, _ in spy.stepped]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fetched = []
            for j, (_, host, *_) in enumerate(spy.dealt):
                entry = spy.entries[j % len(spy.entries)]
                wire = scanstep.deal_wire(host, entry)
                with on_device(entry):
                    fetched.append(scanstep.rows_to_host(
                        scanstep.scan_step(wire, *spy.stepped[j][1])))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        for (rows, done), ref in zip(fetched, want):
            done.synchronize()
            if not torch.equal(rows.nan_to_num(9.0),
                               ref.cpu().nan_to_num(9.0)):
                raise SmokeError(f"C1 dealt {tag}: rows under the sync "
                                 "debug mode differ")
        by_k = {k: [t for e, t in zip(C1_ENTRIES, walls) if e == k]
                for k in sorted(set(C1_ENTRIES))}
        say("C1", f"scan {tag}: [{args[0]},{args[1]}]x{C1_WINDOWS}, "
            f"{args[2]} panels / {len(args[3])} pairs, one batch (scan "
            f"{wall:.2f} s wall); {batch_text}; dealt in "
            f"{C1_WINDOWS // C1_DEAL_BATCH} batches of {C1_DEAL_BATCH} to "
            "[cuda:0] x " + " / ".join(str(k) for k in C1_ENTRIES)
            + ": batch j on entry j mod k, one scan_step each, copy and "
            "step on one stream; table, journal"
            + (" and spectrum" if flags else "")
            + " byte-equal at every k; scan walls (s, in run order; "
            "median) " + "; ".join(
                f"x {k} " + " / ".join(f"{t:.3f}" for t in ts)
                + f" ({statistics.median(ts):.3f})"
                for k, ts in by_k.items())
            + "; the sync debug mode found no synchronising call in the "
            "dealt copy, step and copy back")


def c1_distributed(tmp, pg):
    """``scan --distributed --afs`` in two processes on the one card (two
    one-GPU hosts of a gloo group), then ``merge-parts`` and ``merge-parts
    --sum``: the table of phase 3 and the spectrum of phase 5."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    out, afs = os.path.join(tmp, "dist.tsv"), os.path.join(tmp, "dist.afs")
    argv = [sys.executable, "-m", "impop_tpu_torch.cli", *pg["base"],
            "--afs", afs, "-o", out, "--batch", "64", "--device", "cuda",
            "--distributed"]
    procs = []
    for rank in range(2):
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="0", LOCAL_RANK="0",
                   RANK=str(rank), WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port))
        procs.append((time.perf_counter(), subprocess.Popen(
            argv, cwd=HERE, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    walls = []
    try:
        for t0, proc in procs:
            _, err = proc.communicate(timeout=600)
            walls.append(time.perf_counter() - t0)
            if proc.returncode != 0:
                raise SmokeError(f"C1 scan --distributed rank exited "
                                 f"{proc.returncode}: {err[-2000:]}")
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    run_cli(["merge-parts", out], "merge-parts")
    run_cli(["merge-parts", afs, "--sum"], "merge-parts --sum")
    header, rows = read_table(out)
    header3, rows3 = read_table(os.path.join(tmp, "3.gpu.tsv"))
    if header != header3:
        raise SmokeError("C1 distributed: header differs from phase 3's")
    compare_tables(header, rows, rows3, "C1 distributed vs phase 3")
    same_file(afs, os.path.join(tmp, "5.gpu.afs"),
              "C1 distributed: merged spectrum differs from phase 5's")
    with open(out) as fa, open(os.path.join(tmp, "3.gpu.tsv")) as fb:
        identical = fa.read() == fb.read()
    say("C1", f"scan --distributed: 2 ranks x {pg['n_win'] // 2} windows "
        f"on cuda:0, walls {walls[0]:.2f} / {walls[1]:.2f} s; merge-parts: "
        f"the {len(rows)}-row table of phase 3 (integers exact, pi/D rtol "
        f"1e-5, Fst atol 2e-3; text identical: "
        f"{'yes' if identical else 'no'}), merge-parts --sum: the spectrum "
        "file of phase 5, identical")


def pair_windows(rng, n_win):
    """``n_win`` windows [N, S] = [2048, 128] of 12 haplotype classes with
    0.2% private flips and 1% missing calls; the last 40 rows are not
    members, the last 9 sites masked off; ten pairs of five panels."""
    import numpy as np

    g = np.empty((n_win, PAIR_N, PAIR_S), np.int8)
    for wi in range(n_win):
        classes = rng.integers(0, 2, size=(12, PAIR_S)).astype(np.int8)
        gw = classes[rng.integers(0, 12, size=PAIR_N)]
        gw = np.where(rng.random(gw.shape) < 0.002, 1 - gw, gw)
        gw[rng.random(gw.shape) < 0.01] = -1
        g[wi] = gw
    member = np.ones((n_win, PAIR_N), bool)
    member[:, -40:] = False
    smask = np.ones((n_win, PAIR_S), bool)
    smask[:, -9:] = False
    edges = np.linspace(0, PAIR_N - 40, 6).astype(int)
    pairs = [(i, j) for i in range(5) for j in range(i + 1, 5)]
    ma = np.zeros((n_win, PAIR_Q, PAIR_N), bool)
    mb = np.zeros((n_win, PAIR_Q, PAIR_N), bool)
    for q, (i, j) in enumerate(pairs):
        ma[:, q, edges[i]:edges[i + 1]] = True
        mb[:, q, edges[j]:edges[j + 1]] = True
    return g, member, smask, ma, mb


def check_pair_stats(got, ref, s_want, what):
    """Pair-shard outputs against (pi_a, pi_b, dxy, fst) of a reference:
    pi/dxy rtol 1e-5, Fst atol 2e-3, S equal."""
    import numpy.testing as npt

    try:
        for k in range(3):
            npt.assert_allclose(got[k].cpu().numpy(),
                                ref[k].cpu().numpy(), rtol=1e-5, atol=1e-7)
        npt.assert_allclose(got[3].cpu().numpy(), ref[3].cpu().numpy(),
                            rtol=0, atol=2e-3)
    except AssertionError as e:
        raise SmokeError(f"C1 pair shard, {what}: {e}") from None
    if not (got[4].cpu() == s_want.cpu()).all():
        raise SmokeError(f"C1 pair shard, {what}: S {got[4].tolist()} vs "
                         f"{s_want.tolist()}")


def c1_pair_shard(dev, tmp, step):
    """``pair_sharded_direct_stats`` on [cuda:0] x 4 at N = 2048 against
    the replicated [N, N] identity, for one window and for a device batch
    of 16 windows in one call against 16 single calls and the replicated
    batch; then ``hfst --pair-shard on`` against ``off`` on 1200-row
    tiles."""
    import numpy as np
    import numpy.testing as npt
    import torch

    from impop_tpu_torch.hostio import _open_extractor, simulate
    from impop_tpu_torch.parallel.mesh import make_mesh
    from impop_tpu_torch.parallel.pairspace import pair_sharded_direct_stats
    from impop_tpu_torch.stats.allele import (identity_from_alleles,
                                              segregating_sites)
    from impop_tpu_torch.stats.fst import hudson_fst_direct_pairs

    rng = np.random.default_rng(23)
    classes = rng.integers(0, 2, size=(12, PAIR_S)).astype(np.int8)
    g = classes[rng.integers(0, 12, size=PAIR_N)]
    g = np.where(rng.random(g.shape) < 0.002, 1 - g, g).astype(np.int8)
    g[rng.random(g.shape) < 0.01] = -1
    member = np.ones(PAIR_N, bool)
    member[-40:] = False
    smask = np.ones(PAIR_S, bool)
    smask[-9:] = False
    edges = np.linspace(0, PAIR_N - 40, 6).astype(int)
    pairs = [(i, j) for i in range(5) for j in range(i + 1, 5)]
    ma = np.zeros((PAIR_Q, PAIR_N), bool)
    mb = np.zeros((PAIR_Q, PAIR_N), bool)
    for q, (i, j) in enumerate(pairs):
        ma[q, edges[i]:edges[i + 1]] = True
        mb[q, edges[j]:edges[j + 1]] = True
    t = [torch.from_numpy(a).to(dev) for a in (g, member, smask, ma, mb)]
    fn = pair_sharded_direct_stats(make_mesh(data=4, devices=[dev] * 4))
    got = fn(*t, float(WIN_BP))

    def replicated():
        sim, present = identity_from_alleles(t[0], t[1], t[2],
                                             float(WIN_BP))
        return hudson_fst_direct_pairs(sim, present, t[3], t[4])

    ref = replicated()
    try:
        for k, f in enumerate(("pi_a", "pi_b", "dxy")):
            npt.assert_allclose(got[k].cpu().numpy(),
                                getattr(ref, f).cpu().numpy(), rtol=1e-5,
                                atol=1e-7)
        npt.assert_allclose(got[3].cpu().numpy(), ref.fst.cpu().numpy(),
                            rtol=0, atol=2e-3)
    except AssertionError as e:
        raise SmokeError(f"C1 pair shard: {e}") from None
    want_s = int(segregating_sites(t[0], t[1], t[2]))
    if int(got[4]) != want_s:
        raise SmokeError(f"C1 pair shard: S {int(got[4])} vs {want_s}")

    tb = [torch.from_numpy(a).to(dev)
          for a in pair_windows(np.random.default_rng(24), PAIR_W)]
    lengths = torch.full((PAIR_W,), float(WIN_BP), device=dev)
    got_b = fn(*tb, lengths)
    singles = [fn(*(x[wi] for x in tb), float(WIN_BP))
               for wi in range(PAIR_W)]
    stacked = [torch.stack([r[k] for r in singles]) for k in range(5)]
    check_pair_stats(got_b, stacked, stacked[4], "16 windows in one call "
                     "against 16 single calls")

    def replicated_batch():
        sim, present = identity_from_alleles(tb[0], tb[1], tb[2],
                                             float(WIN_BP))
        return hudson_fst_direct_pairs(sim, present, tb[3], tb[4])

    ref_b = replicated_batch()
    check_pair_stats(got_b, (ref_b.pi_a, ref_b.pi_b, ref_b.dxy, ref_b.fst),
                     segregating_sites(tb[0], tb[1], tb[2]),
                     "16 windows in one call against the replicated batch")
    step["c1_pair"] = {   # what: (fn, windows a call of fn)
        "one call a window": (lambda: fn(*t, float(WIN_BP)), 1),
        "replicated, one window": (replicated, 1),
        f"batched, {PAIR_W} windows a call": (lambda: fn(*tb, lengths),
                                              PAIR_W),
        f"{PAIR_W} single calls": (lambda: [
            fn(*(x[wi] for x in tb), float(WIN_BP))
            for wi in range(PAIR_W)], PAIR_W),
        f"replicated, {PAIR_W} windows a call": (replicated_batch, PAIR_W)}
    say("C1", f"pair shard [cuda:0] x 4 at N = {PAIR_N}, S = {PAIR_S}, "
        f"Q = {PAIR_Q}: pi/dxy rtol 1e-5, Fst atol 2e-3, S = {want_s} equal "
        f"to the replicated [{PAIR_N}, {PAIR_N}] path; {PAIR_W} windows in "
        f"one call equal {PAIR_W} single calls and the replicated batch "
        "(pi/dxy rtol 1e-5, Fst atol 2e-3, S equal)")

    sim_dir = os.path.join(tmp, "pairsim")
    os.makedirs(sim_dir)
    span = 4 * WIN_BP
    sim = simulate(sim_dir, ref_len=span, n_haps=PAIR_CLI_ROWS - 1,
                   site_pool=span // 60, seed=31, span=(0, span))
    spans = [(lo, lo + WIN_BP) for lo in range(0, span, WIN_BP)]
    tiles = os.path.join(sim_dir, "tiles")
    wms = write_tiles(_open_extractor(sim.paf_path, sim.fasta_path), spans,
                      tiles)
    if wms[0].geno.shape[0] != PAIR_CLI_ROWS:
        raise SmokeError(f"C1 pair shard: {wms[0].geno.shape[0]} rows")
    bed = os.path.join(sim_dir, "w.bed")
    write_bed(bed, spans)
    samples = sorted({h.name.split("#")[0] for h in sim.haplotypes})
    pop = {}
    for name, part in (("A", samples[:150]), ("B", samples[150:300])):
        pop[name] = os.path.join(sim_dir, f"pop{name}.txt")
        with open(pop[name], "w") as fh:
            fh.write("\n".join(part) + "\n")
    walls = {}
    for mode in ("on", "off"):
        walls[mode] = run_cli(
            ["hfst", "-b", bed, "--geno-dir", tiles, "-P", "CHM13#0#",
             "-A", pop["A"], "-B", pop["B"], "--pair-shard", mode, "-o",
             os.path.join(sim_dir, f"{mode}.tsv"), "--device", dev.type],
            f"hfst --pair-shard {mode}")
    rows = compare_stat_tables(os.path.join(sim_dir, "on.tsv"),
                               os.path.join(sim_dir, "off.tsv"),
                               "C1 hfst --pair-shard", rows=len(spans))
    say("C1", f"hfst --pair-shard on vs off: {len(rows)} windows of "
        f"{PAIR_CLI_ROWS} rows agree (pi/Dxy rtol 1e-5, Fst/Da atol 2e-3); "
        f"walls {walls['on']:.2f} / {walls['off']:.2f} s")


def c1_long_window(dev, step):
    """``site_sharded_window_stats`` on a (2, 2) grid of cuda:0 against a
    (1, 1) grid at [512, 8192] x 8."""
    import numpy as np
    import torch

    from impop_tpu_torch.parallel.longwindow import site_sharded_window_stats
    from impop_tpu_torch.parallel.mesh import make_mesh

    arrays = long_batch(np.random.default_rng(29), LONG_W, cap_s=LONG_S)
    t = to_dev(dev, *arrays)
    grid = site_sharded_window_stats(make_mesh(2, 2, [dev] * 4), CAP_N)
    one = site_sharded_window_stats(make_mesh(1, 1, [dev]), CAP_N)
    (pi, s, d), (pi1, s1, d1) = grid(*t, THRESHOLD), one(*t, THRESHOLD)
    if not torch.equal(s, s1):
        raise SmokeError(f"C1 long window: S {s.tolist()} vs {s1.tolist()}")
    if not torch.allclose(pi, pi1, rtol=1e-5, atol=1e-9):
        raise SmokeError(f"C1 long window: pi {pi.tolist()} vs "
                         f"{pi1.tolist()}")
    if not torch.allclose(d.nan_to_num(9.0), d1.nan_to_num(9.0), rtol=0,
                          atol=2e-3):
        raise SmokeError(f"C1 long window: D {d.tolist()} vs {d1.tolist()}")
    step["c1_long"] = (lambda: grid(*t, THRESHOLD),
                       lambda: one(*t, THRESHOLD))
    pi_same = "equal" if torch.equal(pi, pi1) else "rtol 1e-5"
    say("C1", f"long window (2, 2) grid of cuda:0 at [{CAP_N}, {LONG_S}] x "
        f"{LONG_W}: S equal, pi {pi_same}, D atol 2e-3 against (1, 1)")


def phase_multidevice(dev, tmp, pg, step):
    """C1: the multi-device and multi-host paths on the one card."""
    from impop_tpu_torch.parallel.dryrun import dryrun_multidevice

    t0 = time.perf_counter()
    c1_scan(dev, tmp, pg, step)
    c1_distributed(tmp, pg)
    c1_pair_shard(dev, tmp, step)
    c1_long_window(dev, step)
    report = dryrun_multidevice(8, "cuda:0")
    say("C1", "dryrun_multidevice(8, cuda:0) passed: largest differences "
        + ", ".join(f"{k} {v}" for k, v in report.items())
        + f"; C1 took {time.perf_counter() - t0:.1f} s")


def time_multidevice(step, smi):
    """C1's timings, outside the counted path: the dealt scan step at 1, 2
    and 4 entries of cuda:0 and the step alone (CUDA events, and the
    card's busy share by torch.profiler), the pair shard against the
    replicated path, and the long window's (2, 2) grid against (1, 1)."""
    import torch

    from impop_tpu_torch import scanstep
    from impop_tpu_torch.device import on_device

    for tag, wire, args, w in step["c1_scan"]:
        def dealt(k, wire=wire, args=args):
            entries = [torch.device(wire.device.type, wire.device.index)
                       for _ in range(k)]

            def run():
                for j in range(C1_DEALT_TIMED):
                    with on_device(entries[j % k]):
                        scanstep.rows_to_host(scanstep.scan_step(wire, *args))
            return run

        def step_alone(wire=wire, args=args):
            for _ in range(C1_DEALT_TIMED):
                scanstep.scan_step(wire, *args)

        fns = {k: dealt(k) for k in (1, 2, 4)}
        ms = {k: cuda_time_ms(fn, 10) / C1_DEALT_TIMED
              for k, fn in fns.items()}
        alone = cuda_time_ms(step_alone, 10) / C1_DEALT_TIMED
        say("C1", f"dealt scan step {tag} [{args[0]},{args[1]}]x{w} per "
            f"batch ({C1_DEALT_TIMED} whole batches dealt over k entries, "
            "each the step and the copy of its rows to the host): "
            + ", ".join(f"x {k} {v:.4f} ms" for k, v in ms.items())
            + f", the step alone {alone:.4f} ms"
            + f" (CUDA events; {smi}); x 4 by kernel, {C1_DEALT_TIMED} "
            "batches: " + profile_ops(fns[4], C1_DEALT_TIMED * ms[4], top=4))
    grid, one = step["c1_long"]
    pair_ms = {}
    for what, (fn, n_win) in step["c1_pair"].items():
        pair_ms[what] = cuda_time_ms(fn, 10) / n_win
    say("C1", f"pair shard [cuda:0] x 4 at N = {PAIR_N}, ms per window: "
        + ", ".join(f"{k} {v:.4f}" for k, v in pair_ms.items())
        + f"; long window [{CAP_N}, {LONG_S}] x {LONG_W}: (2, 2) "
        f"{cuda_time_ms(grid, 5):.4f} ms, (1, 1) {cuda_time_ms(one, 5):.4f} "
        f"ms (CUDA events; {smi})")


# ------------------------------------------------------------------ D1

BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "vs_baseline_detail",
              "e2e", "long_window", "ehh", "ehh_fused", "device"}


def run_twin(tag, main, argv) -> list:
    """One of impop_tpu_torch.bench's entry points in this process, its
    output said under D1; fails unless it returns 0.  Returns its lines."""
    import contextlib
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    for ln in lines:
        say("D1", f"{tag}: {ln}")
    if rc:
        raise SmokeError(f"D1: {tag} {' '.join(argv)} exited {rc}")
    say("D1", f"{tag} took {time.perf_counter() - t0:.1f} s")
    return lines


def d1_seed_guard(dev):
    """The seed-pair debug guard on the card, on tests/test_panelstats.py's
    guard inputs (4 members, two panels of two, every member its own seed)
    padded with non-member rows to N = 32, the seed peel's width: silent
    with every pair present, one missing pair (the JAX guard's count on
    the unpadded inputs) for disjoint and overlapping pairs when the (0,
    2) cross pair lacks data."""
    import re
    import warnings

    import torch

    from impop_tpu_torch.stats import panelstats

    n = 32
    member = torch.zeros(n, dtype=torch.bool, device=dev)
    member[:4] = True
    pmasks = torch.zeros((2, n), dtype=torch.bool, device=dev)
    pmasks[0, :2] = True
    pmasks[1, 2:4] = True
    sim = torch.full((n, n), 0.5, device=dev).fill_diagonal_(1.0)
    ok = torch.ones((n, n), dtype=torch.bool, device=dev)
    bad = ok.clone()
    bad[0, 2] = bad[2, 0] = False
    saved = panelstats.DEBUG_SEED_INVARIANT
    panelstats.DEBUG_SEED_INVARIANT = True
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            panelstats.fused_panel_stats(sim, ok, member, pmasks, (0,), (1,),
                                         0.999, pairs_disjoint=True)
        for disjoint in (True, False):
            with warnings.catch_warnings(record=True) as rec:
                warnings.simplefilter("always")
                panelstats.fused_panel_stats(sim, bad, member, pmasks, (0,),
                                             (1,), 0.999,
                                             pairs_disjoint=disjoint)
            counts = [int(m.group(1)) for m in (
                re.search(r"(\d+) group-seed pair", str(w.message))
                for w in rec) if m]
            if counts != [1]:
                raise SmokeError(f"D1: the seed-pair guard (pairs_disjoint="
                                 f"{disjoint}) warned {counts}, not [1]")
    finally:
        panelstats.DEBUG_SEED_INVARIANT = saved
    say("D1", "seed-pair debug guard on the card: silent with every seed "
        "pair present, one missing pair counted for disjoint and for "
        "overlapping pairs (the JAX guard's count)")


def phase_bench_twins(dev):
    """D1: the port's measurement and verification entry points on the
    card at small sizes, and the debug guard."""
    from impop_tpu_torch.bench import (check_device_oracle, gpu_smoke,
                                       pairwise, panelstep, windowstat)
    from impop_tpu_torch.bench import main as bench_main

    t0 = time.perf_counter()
    lines = run_twin("bench", bench_main.main,
                     ["--batch", "320", "--iters", "4", "--e2e-mb", "2",
                      "--baseline-windows", "2", "--baseline-passes", "1"])
    out = json.loads(lines[-1])
    if set(out) != BENCH_KEYS or any(
            "error" in out[k] for k in ("e2e", "long_window", "ehh",
                                        "ehh_fused")):
        raise SmokeError(f"D1: the bench's line is malformed: {lines[-1]}")
    if not (out["value"] > 0 and out["e2e"]["windows"] == 400):
        raise SmokeError(f"D1: the bench's numbers are off: {lines[-1]}")
    run_twin("check_device_oracle", check_device_oracle.main, [])
    run_twin("gpu_smoke", gpu_smoke.main, [])
    run_twin("pairwise", pairwise.main, ["--reps", "5"])
    run_twin("panelstep", panelstep.main, ["--iters", "4"])
    run_twin("windowstat", windowstat.main,
             ["--windows", "320", "--sweep-windows", "8", "--iters", "2"])
    d1_seed_guard(dev)
    say("D1", f"D1 took {time.perf_counter() - t0:.1f} s")


# ------------------------------------------------------------------ E1

HOSTILE_BP, HOSTILE_WIN = 60_000, 3000


def hostile_chromosome(tmp):
    """The JAX package's adversarial acceptance fixture
    (tests/test_acceptance_hostile.py): 60 kb x 20 haplotypes with ragged
    coverage, p_indel 0.7 and strand flips; twenty 3 kb windows and one
    past every alignment; panels PA and PB of four samples, a ghost panel
    PG, and five metadata panels of two samples."""
    from impop_tpu_torch.extract.simulate import simulate

    d = os.path.join(tmp, "hostile")
    md = os.path.join(d, "metadata")
    os.makedirs(md)
    sim = simulate(d, ref_len=HOSTILE_BP, n_haps=20, site_pool=500,
                   p_indel=0.7, seed=23, span=None)
    bed = os.path.join(d, "w.bed")
    write_bed(bed, [(lo, lo + HOSTILE_WIN)
                    for lo in range(0, HOSTILE_BP, HOSTILE_WIN)]
              + [(90_000, 93_000)])
    samples = sorted({h.name.split("#")[0] for h in sim.haplotypes})
    lists = {"PA": samples[:4], "PB": samples[4:8],
             "PG": ["ZZ99998", "ZZ99999"]}
    lists.update({f"metadata/{grp}": samples[2 * gi:2 * gi + 2]
                  for gi, grp in enumerate(("EUR", "AFR", "EAS", "SAS",
                                            "AMR"))})
    files = {}
    for name, members in lists.items():
        head, _, tail = name.rpartition("/")
        files[tail] = os.path.join(d, head, f"agc.{tail}")
        with open(files[tail], "w") as fh:
            fh.write("\n".join(members) + "\n")
    base = ["scan", "-b", bed, "--paf", sim.paf_path, "--fasta",
            sim.fasta_path, "-P", "CHM13#0#"]
    for p in ("PA", "PB", "PG"):
        base += ["--panel", files[p]]
    return {"dir": d, "sim": sim, "bed": bed, "files": files, "md": md,
            "base": base, "n_win": HOSTILE_BP // HOSTILE_WIN + 1}


def read_journal(path) -> dict:
    with open(path) as fh:
        recs = [json.loads(ln) for ln in fh if ln.strip()]
    return {r["region"]: r for r in recs}


def compare_journals(path_a, path_b, header, tag) -> dict:
    """Two scans' journals of the same windows: the same regions, NA
    records in the same places, rows as ``compare_tables`` holds them,
    spectra equal.  Returns the first's records by region."""
    ja, jb = read_journal(path_a), read_journal(path_b)
    if sorted(ja) != sorted(jb):
        raise SmokeError(f"{tag}: the journals hold other regions")
    for region, ra in ja.items():
        rb = jb[region]
        if ra.get("status") != rb.get("status") or ("row" in ra) != (
                "row" in rb) or ra.get("afs") != rb.get("afs"):
            raise SmokeError(f"{tag}: journal records of {region} differ")
        if "row" in ra:
            compare_tables(header, [ra["row"].split("\t")],
                           [rb["row"].split("\t")], f"{tag} journal")
    return ja


def e1_scan(dev, h, tag, flags, afs=False) -> tuple:
    """``scan <flags>`` over the hostile chromosome on the card and on the
    CPU: tables, journals and spectra compared; every window journaled,
    none NA.  Returns (the card's table, walls by device)."""
    walls, outs = {}, {}
    for label, side in (("card", dev.type), ("cpu", "cpu")):
        p = os.path.join(h["dir"], f"{tag}.{label}")
        walls[label] = run_cli(
            h["base"] + flags + (["--afs", p + ".afs"] if afs else [])
            + ["--journal", p + ".jsonl", "-o", p + ".tsv", "--device",
               side], f"E1 scan {' '.join(flags)} --device {side}")
        outs[label] = p
    header, rows = read_table(outs["card"] + ".tsv")
    _, rows_cpu = read_table(outs["cpu"] + ".tsv")
    if len(rows) != h["n_win"]:
        raise SmokeError(f"E1 {tag}: {len(rows)} rows, want {h['n_win']}")
    compare_tables(header, rows, rows_cpu, f"E1 {tag} card-vs-cpu")
    recs = compare_journals(outs["card"] + ".jsonl", outs["cpu"] + ".jsonl",
                            header, f"E1 {tag}")
    if len(recs) != h["n_win"] or any(r.get("status") == "NA"
                                      for r in recs.values()):
        raise SmokeError(f"E1 {tag}: journal has {len(recs)} records or an "
                         "NA one (want 21 successes)")
    if afs:
        same_file(outs["card"] + ".afs", outs["cpu"] + ".afs",
                  f"E1 {tag}: card and CPU spectrum files differ")
    return outs["card"] + ".tsv", walls


def hostile_sim_dict(g, names, length) -> dict:
    """{(a, b): the f32 similarity the card computes} for every pair of
    sorted names with a compared site."""
    import numpy as np

    valid = g >= 0
    both = valid[:, None, :] & valid[None, :, :]
    dcount = ((g[:, None, :] != g[None, :, :]) & both).sum(-1)
    simm = np.float32(1.0) - dcount.astype(np.float32) / np.float32(length)
    comp = both.sum(-1)
    n = len(names)
    return {(names[i], names[j]): float(simm[i, j])
            for i in range(n) for j in range(i + 1, n) if comp[i, j] > 0}


def hostile_seg_sites(g) -> int:
    import numpy as np

    valid = g >= 0
    gmax = np.where(valid, g, -1).max(axis=0)
    gmin = np.where(valid, g, 127).min(axis=0)
    return int((valid.any(axis=0) & (gmax > gmin)).sum())


def e1_pin_oracle(h, table) -> int:
    """Every window with data of the card's ``scan --ehh`` table against
    ``impop_tpu_torch/bench/oracle.py`` through the native extraction, with
    tests/test_acceptance_hostile.py's pins: S exact, π within 1e-4
    relative or 1e-3 absolute, the ghost panel's π 0, direct and grouped
    Fst within 2e-3.  Returns the windows checked."""
    import numpy as np

    from impop_tpu_torch.bench import oracle
    from impop_tpu_torch.extract import NativeExtractor
    from impop_tpu_torch.io.panels import expand_population

    t32 = float(np.float32(THRESHOLD))
    header, rows = read_table(table)
    col = {name: i for i, name in enumerate(header)}
    lists = {}
    for p in ("PA", "PB"):
        with open(h["files"][p]) as fh:
            lists[p] = fh.read().split()
    checked = 0
    with NativeExtractor(h["sim"].paf_path, h["sim"].fasta_path) as nat:
        for row in rows:
            start, end = map(int, row[0].rsplit(":", 1)[1].split("-"))
            wm = nat.extract("CHM13#0#chr1", start, end)
            order = np.argsort(wm.names)
            g = np.asarray(wm.geno)[order]
            names = [wm.names[i] for i in order]
            if g.shape[0] == 0:
                continue
            length = float(end - start)
            sd = hostile_sim_dict(g, names, length)
            if int(row[col["SEGREGATING_SITES"]]) != hostile_seg_sites(g):
                raise SmokeError(f"E1 oracle: S at {row[0]}")
            stems = [nm.split(":", 1)[0] for nm in names]
            members = {}
            for p in ("PA", "PB"):
                hit, _ = expand_population(lists[p], stems)
                members[p] = [nm for nm, st in zip(names, stems)
                              if st in hit]
                keep = set(members[p])
                want, _ = oracle.pica2_pi(
                    {k: v for k, v in sd.items()
                     if k[0] in keep and k[1] in keep}, members[p], t32)
                got = float(row[col[f"PI_{p}"]]) * length
                if abs(want - got) > max(1e-4 * abs(want), 1e-3):
                    raise SmokeError(f"E1 oracle: PI_{p} at {row[0]}: "
                                     f"{got} vs {want}")
            if float(row[col["PI_PG"]]) != 0.0:
                raise SmokeError(f"E1 oracle: the ghost panel's pi at "
                                 f"{row[0]} is {row[col['PI_PG']]}")
            if members["PA"] and members["PB"]:
                for key, fn in (("FST_PA_PB", oracle.hudson_fst_direct),
                                ("FSTG_PA_PB", oracle.hudson_fst_grouped)):
                    extra = (t32,) if key.startswith("FSTG") else ()
                    want = fn(sd, members["PA"], members["PB"], *extra)["fst"]
                    got = float(row[col[key]])
                    if abs(want - got) >= 2e-3:
                        raise SmokeError(f"E1 oracle: {key} at {row[0]}: "
                                         f"{got} vs {want}")
            checked += 1
    if checked < 10:
        raise SmokeError(f"E1 oracle: only {checked} windows with data")
    return checked


def e1_crafted(dev, h) -> tuple:
    """The crafted tiles of tests/test_acceptance_hostile.py through
    ``scan --geno-dir`` on the card and on the CPU: a multiallelic column
    split for the 2-bit wire, disjoint coverage that trips the exact-FSTG
    recompute (held to the oracle's first-found-pair FSTG within 2e-3), and
    a missing tile: one NA journal record, three rows.  Returns (windows
    pinned, walls)."""
    import numpy as np

    from impop_tpu_torch.bench import oracle
    from impop_tpu_torch.hostio import split_multiallelic

    d = os.path.join(h["dir"], "crafted")
    tiles = os.path.join(d, "tiles")
    os.makedirs(tiles)
    rng = np.random.default_rng(3)
    n, s = 12, 24
    names = [f"HG{90000 + i // 2:05d}#{i % 2 + 1}#c{i}" for i in range(n)]
    genos = []
    for wi in range(3):
        g = rng.integers(0, 2, size=(n, s)).astype(np.int8)
        g[:, 5] = rng.integers(0, 3, size=n)
        g[: n // 2, s // 2:] = -1
        g[n // 2:, : s // 2] = -1
        lo = wi * 1000
        np.savez(os.path.join(tiles, f"chr1:{lo}-{lo + 1000}.npz"), geno=g,
                 names=np.asarray(names),
                 site_keys=np.asarray([f"{lo + 10 + 3 * k}:snp"
                                       for k in range(s)]))
        genos.append(g)
    bed = os.path.join(d, "w.bed")
    write_bed(bed, [(wi * 1000, wi * 1000 + 1000) for wi in range(4)])
    panels = []
    for name, ids in (("QA", range(3)), ("QB", range(3, 6))):
        panels += ["--panel", os.path.join(d, f"agc.{name}")]
        with open(panels[-1], "w") as fh:
            fh.write("\n".join(f"HG{90000 + i:05d}" for i in ids) + "\n")
    walls = {}
    for label, side in (("card", dev.type), ("cpu", "cpu")):
        walls[label] = run_cli(
            ["scan", "-b", bed, "--geno-dir", tiles, "-P", "", *panels,
             "--journal", os.path.join(d, f"{label}.jsonl"), "-o",
             os.path.join(d, f"{label}.tsv"), "--device", side],
            f"E1 crafted scan --device {side}")
    header, rows = read_table(os.path.join(d, "card.tsv"))
    _, rows_cpu = read_table(os.path.join(d, "cpu.tsv"))
    compare_tables(header, rows, rows_cpu, "E1 crafted card-vs-cpu")
    recs = compare_journals(os.path.join(d, "card.jsonl"),
                            os.path.join(d, "cpu.jsonl"), header,
                            "E1 crafted")
    n_na = sum(r.get("status") == "NA" for r in recs.values())
    if len(rows) != 3 or n_na != 1:
        raise SmokeError(f"E1 crafted: {len(rows)} rows and {n_na} NA "
                         "records, want 3 and 1")
    order = np.argsort(names)
    nms = [names[i] for i in order]
    qa, qb = ([nm for nm in nms if nm[:7] in {f"HG{90000 + i:05d}"
                                              for i in ids}]
              for ids in (range(3), range(3, 6)))
    col = {name: i for i, name in enumerate(header)}
    pinned = 0
    for g, row in zip(genos, rows):
        g2, _ = split_multiallelic(g, [f"{k}:x" for k in range(s)])
        if int(row[col["SEGREGATING_SITES"]]) != hostile_seg_sites(g2):
            raise SmokeError(f"E1 crafted: S at {row[0]}")
        want = oracle.hudson_fst_grouped(
            hostile_sim_dict(g2[order], nms, 1000.0), qa, qb,
            float(np.float32(THRESHOLD)))["fst"]
        got = float(row[col["FSTG_QA_QB"]])
        if not np.isnan(want):
            if abs(want - got) >= 2e-3:
                raise SmokeError(f"E1 crafted: FSTG at {row[0]}: {got} vs "
                                 f"{want}")
            pinned += 1
    if pinned < 1:
        raise SmokeError("E1 crafted: no window exercised the grouped path")
    return pinned, walls


def e1_workflow(dev, h) -> dict:
    """extract, then panels-tajd, panels-hfst and sfs on the tiles on the
    card and on the CPU (each in its own directory: the panels-* commands
    write into the working directory), then plot where matplotlib is
    installed.  The .tj and .fst tables as ``compare_stat_tables`` holds
    them, the spectrum files identical.  Returns the walls."""
    import glob
    import importlib.util

    tiles = os.path.join(h["dir"], "tiles")
    sim = h["sim"]
    walls = {"extract": run_cli(
        ["extract", "-b", h["bed"], "--paf", sim.paf_path, "--fasta",
         sim.fasta_path, "-P", "CHM13#0#", "--out-dir", tiles],
        "E1 extract")}
    if len(glob.glob(os.path.join(tiles, "*.npz"))) < 15:
        raise SmokeError("E1 extract wrote fewer than 15 tiles")
    cwd = os.getcwd()
    dirs = {}
    try:
        for label, side in (("card", dev.type), ("cpu", "cpu")):
            dirs[label] = os.path.join(h["dir"], f"workflow.{label}")
            os.makedirs(dirs[label])
            os.chdir(dirs[label])
            common = ["-b", h["bed"], "--geno-dir", tiles, "-P", "CHM13#0#",
                      "--device", side]
            for cmd in ("panels-tajd", "panels-hfst"):
                walls[f"{cmd} {label}"] = run_cli(
                    [cmd, *common, "--metadata-dir", h["md"]],
                    f"E1 {cmd} --device {side}")
            walls[f"sfs {label}"] = run_cli(
                ["sfs", *common, "--panel", h["files"]["EUR"], "--panel",
                 h["files"]["AFR"], "-o", "sfs.tsv"],
                f"E1 sfs --device {side}")
    finally:
        os.chdir(cwd)
    card, cpu = dirs["card"], dirs["cpu"]
    tables = sorted(os.path.basename(p) for p in
                    glob.glob(os.path.join(card, "*.tj"))
                    + glob.glob(os.path.join(card, "*.fst")))
    if sum(t.endswith(".tj") for t in tables) != 5 or len(tables) != 15:
        raise SmokeError(f"E1 workflow: tables {tables}")
    for name in tables:
        rows = compare_stat_tables(os.path.join(card, name),
                                   os.path.join(cpu, name),
                                   f"E1 {name} card-vs-cpu", rows=10 ** 6)
        if len(rows) < 15:
            raise SmokeError(f"E1 workflow: {name} has {len(rows)} rows")
    same_file(os.path.join(card, "sfs.tsv"), os.path.join(cpu, "sfs.tsv"),
              "E1 workflow: card and CPU spectrum files differ")
    if importlib.util.find_spec("matplotlib") is None:
        walls["plot"] = "not run: this host has no matplotlib"
    else:
        png = os.path.join(card, "tajd.png")
        walls["plot"] = run_cli(
            ["plot", "tajd", "--input", f"EUR={card}/eur.tj", "--input",
             f"AFR={card}/afr.tj", "--output", png], "E1 plot")
        if os.path.getsize(png) <= 1000:
            raise SmokeError("E1 plot wrote a PNG of at most 1000 bytes")
    return walls


def e1_crash_resume(dev, h) -> dict:
    """A ``--device cuda`` scan of the hostile chromosome in a child process
    (``--batch 2 --drain-group 1``; the child sleeps 50 ms after each
    journal record, so that the kill lands mid-scan) gets SIGKILL once its
    journal holds two records; a torn tail is appended; the resumed scan
    in this process gives the clean run's table byte for byte and grows
    the journal."""
    import signal

    d = os.path.join(h["dir"], "crash")
    os.makedirs(d)

    def argv(name, journal):
        return h["base"] + ["--batch", "2", "--drain-group", "1",
                            "--journal", journal, "-o",
                            os.path.join(d, name), "--device", dev.type]

    walls = {"clean": run_cli(argv("clean.tsv", os.path.join(
        d, "clean.jsonl")), "E1 clean scan")}
    journal = os.path.join(d, "crash.jsonl")
    code = ("import sys, time\n"
            "sys.path.insert(0, %r)\n"
            "from impop_tpu_torch.runtime.journal import ResultJournal\n"
            "record = ResultJournal.record\n"
            "def slow(self, region, payload):\n"
            "    record(self, region, payload)\n"
            "    time.sleep(0.05)\n"
            "ResultJournal.record = slow\n"
            "from impop_tpu_torch.cli import main\n"
            "sys.exit(main(%r))\n") % (HERE, argv("crash.tsv", journal))
    t0 = time.perf_counter()
    with open(os.path.join(d, "child.err"), "w") as err:
        proc = subprocess.Popen([sys.executable, "-c", code],
                                stdout=subprocess.DEVNULL, stderr=err)
    killed_at = None
    try:
        deadline = time.time() + 300
        while time.time() < deadline and proc.poll() is None:
            if os.path.exists(journal):
                with open(journal) as fh:
                    n = sum(1 for _ in fh)
                if n >= 2:
                    os.kill(proc.pid, signal.SIGKILL)
                    killed_at = n
                    break
            time.sleep(0.002)
    finally:
        if proc.poll() is None and killed_at is None:
            proc.kill()
        proc.wait(timeout=60)
    if killed_at is None or killed_at >= h["n_win"]:
        with open(os.path.join(d, "child.err")) as fh:
            tail = fh.read()[-2000:]
        raise SmokeError(f"E1: the child scan was not killed mid-scan "
                         f"(exit {proc.returncode}, journal {killed_at}): "
                         f"{tail}")
    walls["killed"] = time.perf_counter() - t0
    with open(journal, "a") as fh:
        fh.write('{"region": "CHM13#0#chr1:tor')
    with open(journal) as fh:
        n_before = sum(1 for ln in fh if ln.strip())
    walls["resume"] = run_cli(argv("resume.tsv", journal), "E1 resume")
    same_file(os.path.join(d, "clean.tsv"), os.path.join(d, "resume.tsv"),
              "E1: the resumed table differs from the clean card run")
    with open(journal) as fh:
        n_after = sum(1 for ln in fh if ln.strip())
    if not (n_after >= h["n_win"] and n_after > n_before):
        raise SmokeError(f"E1: journal {n_before} -> {n_after} lines")
    walls["records at kill"] = killed_at
    return walls


def fmt_walls(walls: dict) -> str:
    return ", ".join(f"{k} {v:.2f} s" if isinstance(v, float) else f"{k} {v}"
                     for k, v in walls.items())


def phase_acceptance(dev, tmp, smi):
    """E1: the JAX package's acceptance workflows on the card, each held to
    ``--device cpu`` and to ``bench/oracle.py``."""
    t0 = time.perf_counter()
    h = hostile_chromosome(tmp)
    say("E1", f"hostile chromosome (60 kb x 20 haplotypes, p_indel 0.7, "
        f"ragged coverage, ghost panel) in {time.perf_counter() - t0:.1f} s")
    table, walls = e1_scan(dev, h, "ehh", ["--ehh"])
    checked = e1_pin_oracle(h, table)
    say("E1", f"scan --ehh: 21 rows, card equals CPU (table and journal), "
        f"{checked} windows with data pinned to bench/oracle.py; walls "
        f"{fmt_walls(walls)}")
    _, walls = e1_scan(dev, h, "columns", ["--identity-mode", "columns"],
                       afs=True)
    say("E1", f"scan --identity-mode columns --afs: card equals CPU (table, "
        f"journal, spectrum identical); walls {fmt_walls(walls)}")
    pinned, walls = e1_crafted(dev, h)
    say("E1", f"crafted tiles: multiallelic split, {pinned} seed_risk "
        f"window(s) pinned to the oracle's FSTG, one NA record; card "
        f"equals CPU; walls {fmt_walls(walls)}")
    walls = e1_workflow(dev, h)
    say("E1", f"extract -> panels-tajd -> panels-hfst -> sfs -> plot: 5 .tj "
        f"and 10 .fst tables card equal CPU, spectrum identical; walls "
        f"{fmt_walls(walls)}")
    walls = e1_crash_resume(dev, h)
    say("E1", f"SIGKILL mid-scan on the card, torn tail, resume: table "
        f"byte-equal to the clean card run; {fmt_walls(walls)}")
    say("E1", f"E1 took {time.perf_counter() - t0:.1f} s on {smi}")


# ------------------------------------------------------------------ driver


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 3

    from impop_tpu_torch.device import resolve_device
    from impop_tpu_torch.ops import _build
    from impop_tpu_torch.ops.ehhdeath import ehh_area
    from impop_tpu_torch.ops.idgroup import identity_group
    from impop_tpu_torch.ops.pairdiff import (pairwise_identity,
                                              pairwise_identity_weighted)
    from impop_tpu_torch.ops.panelquad import masked_pair_sums
    from impop_tpu_torch.ops.seedpeel import seed_peel
    from impop_tpu_torch.ops.windowstat import window_stats

    dev = resolve_device("cuda")
    smi = nvidia_smi_line()
    nvcc = _build.nvcc_path()
    nvcc_ver = subprocess.run([nvcc, "--version"], capture_output=True,
                              text=True).stdout.strip().splitlines()[-1]
    say("0", f"device {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; nvidia-smi: {smi}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}, nvcc {nvcc_ver}; "
        f"python {sys.version.split()[0]}; CUTLASS headers "
        f"{'present' if os.path.isdir('/usr/local/cutlass/include') else 'absent'}")

    t0 = time.perf_counter()
    _build.load_library()
    say("1", f"built and loaded csrc/*.cu for sm_90a in "
        f"{time.perf_counter() - t0:.2f} s")

    kernels = {"window_stats": window_stats, "seed_peel": seed_peel,
               "ehh_area": ehh_area,
               "pairwise_identity_weighted": pairwise_identity_weighted,
               "masked_pair_sums": masked_pair_sums,
               "pairwise_identity": pairwise_identity,
               "identity_group": identity_group}
    sources = {
        "window_stats": ("windowstat.cu", "impop_tpu/ops/windowstat.py:407"),
        "seed_peel": ("windowstat.cu", "impop_tpu/ops/seedpeel.py:156"),
        "ehh_area": ("ehhdeath.cu", "impop_tpu/ops/ehhdeath.py:173"),
        "pairwise_identity_weighted": ("pairdiff.cu",
                                       "impop_tpu/ops/pairdiff.py:486"),
        "masked_pair_sums": ("panelquad.cu", "impop_tpu/ops/panelquad.py:77"),
        "pairwise_identity": ("pairdiff.cu",
                              "impop_tpu/ops/pairdiff.py:403,460,281"),
        "identity_group": ("idgroup.cu", "impop_tpu/ops/idgroup.py:211"),
    }
    report = {name: {"name": name, "route": "cuda",
                     "source": f"impop_tpu_torch/csrc/{src}",
                     "replaces": replaces, "launches": 0}
              for name, (src, replaces) in sources.items()}
    profiles = []
    phase_kernels(dev, report, profiles)
    phase_ehh_kernel(dev, report, profiles)
    phase_weighted_kernels(dev, report, profiles)
    phase_identity_kernel(dev, report)
    phase_idgroup_kernel(dev, report, profiles)
    phase_degenerate(dev, report)
    for tag, text, fn, ms in profiles:
        say(tag, text + profile_ops(fn, ms))

    # the main paths, each through the port's CLI entry point: every launch
    # count is 0 just before a path and must be nonzero for each kernel of
    # that path just after it
    tmp = tempfile.mkdtemp(prefix="impop_smoke_")
    try:
        pg = simulate_pangenome(tmp)
        step = {}
        paths = [
            ("3-4", lambda: (scan_path(dev, tmp, pg, "3", []),
                             phase_seed_risk(dev, tmp)),
             ("window_stats", "seed_peel", "pairwise_identity")),
            ("5", lambda: scan_path(dev, tmp, pg, "5", ["--ehh"], afs=True),
             ("window_stats", "ehh_area")),
            ("6", lambda: scan_path(dev, tmp, pg, "6",
                                    ["--identity-mode", "columns", "--ehh"],
                                    resume=False),
             ("pairwise_identity_weighted", "masked_pair_sums", "seed_peel",
              "ehh_area")),
            ("7", lambda: phase_tajd(dev, tmp, pg, step),
             ("pairwise_identity", "seed_peel")),
            ("8", lambda: phase_matrices(dev),
             ("identity_group", "masked_pair_sums")),
            ("A1", lambda: phase_route(dev),
             ("pairwise_identity", "seed_peel", "masked_pair_sums")),
            ("9", lambda: phase_stats(dev, tmp, pg, step),
             ("seed_peel", "masked_pair_sums")),
            ("B1", lambda: phase_ehh_sfs(dev, tmp, pg, step, smi),
             ("ehh_area",)),
            ("C1", lambda: phase_multidevice(dev, tmp, pg, step),
             ("window_stats", "seed_peel", "ehh_area",
              "pairwise_identity_weighted", "masked_pair_sums",
              "pairwise_identity")),
            ("D1", lambda: phase_bench_twins(dev), tuple(kernels)),
            ("E1", lambda: phase_acceptance(dev, tmp, smi),
             ("window_stats", "seed_peel", "ehh_area", "pairwise_identity",
              "pairwise_identity_weighted", "masked_pair_sums")),
        ]
        for tag, run, needed in paths:
            for fn in kernels.values():
                fn.launches = 0
            run()
            counts = {name: fn.launches for name, fn in kernels.items()}
            for name in needed:
                if counts[name] == 0:
                    raise SmokeError(f"{name} was never launched by the "
                                     f"scans of phase {tag}")
            for name, count in counts.items():
                report[name]["launches"] += count
            say(tag, f"kernel launches during the path: {counts}")
        time_tajd_step(dev, step)
        time_stats_step(dev, step)
        time_ehh_batch(dev, step, smi)
        time_multidevice(step, smi)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    print(json.dumps({"kernels": list(report.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
