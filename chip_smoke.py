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
         and overlapping pairs, with a Wp that is not 0/1 (the fp32
         branch), the drivers' [512, 512] x 128 with 2 + 2 rows, N = 4160
         (mask words in device memory) and 128 / 256 / 150 value rows
         (one and two grid layers) (0/1 rows of Yp exact, the rest rtol
         1e-5), timed by CUDA graph replay and with the wrapper (CUDA
         events) beside its bound, the all-fp32 bound and two fp32 bmm on
         precomputed operands, the time per value row of one layer and of
         two, profiled by launch after 2j;
     (i) pairwise_identity (unit weights): [512, 2048] x 64, [512, 8192] x 8
         and tajd's [512, 3200] x 10 with kernel, plain and yardstick times
         and a sweep of forced site splits, [1024, 2048] x 4, codes up to 3
         (a member without calls, length 0) and up to 63, ragged [37, 37],
         [37, 1], [1024, 3120] (sim and present exactly equal);
     (j) identity_group: [512, 128] x 320 with R = 15, timed as (h) and
         profiled by launch, cap 256 with overlapping panels, cap 1152,
         [512, 4096] x 8 (present from OR-ed words) (sim, present, gid, S
         exactly equal)
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

Each main path (3-4, 5, 6, 7, 8, A1, 9) starts with every kernel launch count at 0
and fails unless each kernel of that path was launched during it.

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

SCAN_BP = 2_000_000           # simulated pangenome for the scan phase
RTOL = 1e-5                   # floats: f32 sums in another order
ATOL = 1e-6
INT_KEYS = ("n", "num_groups", "pairs_used2", "cnt_aa", "cnt_bb", "cnt_ab",
            "s", "seed_risk")
FLOAT_KEYS = ("quad", "sum_aa", "sum_bb", "sum_ab", "gdxy")


# NVIDIA H100 SXM data sheet, dense: memory rate and peak rates by type
# (int32: 64 lanes per SM, half the fp32 rate)
H100_BYTES_PER_S = 3.35e12
H100_PEAK = {"int8": 1979e12, "bf16": 989e12, "fp32": 67e12,
             "int32": 33.5e12}


class SmokeError(RuntimeError):
    pass


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, **ops) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of the bytes over the memory rate and each type's
    operations over its peak rate."""
    t_bytes = n_bytes / H100_BYTES_PER_S
    t_ops = max((n / H100_PEAK[k] for k, n in ops.items()), default=0.0)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


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


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise SmokeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


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
    return 0.0, int(got[0].max()), args


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
    # past N = 4096 the mask words live in the wrapper's scratch
    n_big = 4160
    big = [torch.from_numpy(a).to(dev) for a in (
        rng.random((2, n_big, n_big), np.float32),
        np.triu(rng.random((2, n_big, n_big)) < 0.9),
        rng.random((2, 2, n_big), np.float32),
        (rng.random((2, 2, n_big)) < 0.3).astype(np.float32))]
    big[1] = big[1] | big[1].transpose(1, 2).clone()
    big[1][:, 5, 7] = False                       # not symmetric
    cases.append((f"N = {n_big} (mask words in device memory)", tuple(big)))
    # value rows past one block's 128 (kValueCap): each further 128 rows
    # take a grid layer that reads sim / present again; 128 and 256 rows
    # are one and two full layers, 150 + 140 is the tests' shape
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
        times[tag] = k_ms
        lines.append(
            f"{tag}, [{CAP_N},{CAP_N}]x{w_}, {xs[2].shape[-2]} + "
            f"{xs[3].shape[-2]} rows: kernel {k_ms:.4f} ms/batch (CUDA graph "
            f"replays; with the wrapper's host time, CUDA events: "
            f"{ev_ms:.4f}) = {k_ms / w_ * 1e3:.3f} us/window; plain "
            f"{p_ms:.4f} ms; bound {b_ms:.4f} ms ({by}), "
            f"{100 * b_ms / k_ms:.1f}% of it (all rows as fp32 FMAs: "
            f"{old_ms:.4f} ms, {old_by}); two fp32 bmm on precomputed "
            f"operands {bmm_ms:.4f} ms")
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
    # what the second layer's second read of sim / present costs: the time
    # per value row of two layers against one, and the read alone at the
    # card's memory rate
    t1, t2 = times[layers[128][0]], times[layers[256][0]]
    reread_ms = bound(nbytes(*timed[:2]))[0]
    say("2h", f"value rows past 128: one layer {t1 / 128 * 1e3:.3f} us per "
        f"value row, two layers {t2 / 256 * 1e3:.3f} us ({t2 / t1:.3f}x the "
        f"time for 2x the rows); the second read of sim / present alone "
        f"{reread_ms:.4f} ms at {H100_BYTES_PER_S / 1e12} TB/s")
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
    share = set_bound(
        report, "window_stats", k_ms, in_out, int8=gram,
        fp32=2 * BATCH * CAP_N * CAP_N * value_rows,
        int32=3 * BATCH * mask_rows * CAP_N * (CAP_N // 32))
    # PR 5's count, every product row as fp32 FMAs, kept for comparison
    # with the shares recorded before (not a bound: the 0/1 rows need none)
    old_ms = bound(in_out, int8=gram,
                   fp32=2 * BATCH * CAP_N * CAP_N * (value_rows + mask_rows))[0]
    say("2a", f"window_stats [{CAP_N},{CAP_S}]x{BATCH} 5 panels/10 pairs "
        f"disjoint: integers exact, floats within rtol {RTOL} (max_abs_err "
        f"{err_a:.3e}); kernel {k_ms:.4f} ms/batch "
        f"= {k_ms / BATCH * 1e3:.3f} us/window; plain {p_ms:.4f} ms/batch "
        f"= {p_ms / BATCH * 1e3:.3f} us/window; {share}; PR 5's count (all "
        f"{value_rows + mask_rows} product rows as fp32 FMAs) {old_ms:.4f} "
        f"ms, {100 * old_ms / k_ms:.1f}% of it")
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


def zv_operands(geno, member, smask):
    """The stacked ±1/0 bf16 operands [z; v] of the unit-weight Grams,
    [2W, N, S], for the one-call yardstick."""
    import torch

    valid = (geno >= 0) & member[..., :, None] & smask[..., None, :]
    v = valid.to(torch.bfloat16)
    z = torch.where(valid, 2 * geno.clamp(min=0) - 1, 0).to(torch.bfloat16)
    return torch.cat([z, v], 0)


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
