"""The port's native extractor against its pure-Python extractor, without
torch.

    python -m impop_tpu_torch.bench.extract_smoke [--threads 4]
        [--sanitize {address,thread}]

Simulates a small pangenome (24 haplotypes, 60 kb) and extracts 2 kb
windows through every native entry point of ``impop_tpu_torch.extract``:
per window, the range batch, the threaded padded fill and the threaded
wire pack (with skipped rows), then reopens the extractor through its
PAF index sidecar.  Each is checked against ``extract/pyfallback`` or a
numpy reference.  Imports no torch, so the native library can run under
a sanitizer preloaded into the process: ``--sanitize`` opens the
extractors on the library built with that sanitizer, and the process must
have been started with its runtime in ``LD_PRELOAD`` (``python -m
impop_tpu_torch.bench.ci_extract`` does both).  Exits non-zero on a
mismatch.  The twin of the repository's ``tools/ci_extract_smoke.py``.
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile

import numpy as np

from impop_tpu_torch.extract import (SANITIZERS, NativeExtractor,
                                     load_library, split_window_matrix)
from impop_tpu_torch.extract.pyfallback import PyExtractor
from impop_tpu_torch.extract.simulate import simulate


def check(ok: bool, what) -> None:
    if not ok:
        raise RuntimeError(f"extract_smoke: {what}")


def check_pack(batch, mats, wts, threads: int) -> None:
    """The threaded wire pack against a numpy pack of the same windows,
    two of them skipped."""
    cap_n = (max(n for n, _ in batch.dims) + 7) // 8 * 8
    cap_s = (max(s for _, s in batch.dims) + 127) // 128 * 128
    o_m = cap_n * (cap_s // 4)
    o_sm = o_m + cap_n // 8
    o_w = o_sm + cap_s // 8
    stride = o_w + 4 * cap_s
    skip = {3, 11}
    out_rows, r = [], 0
    for i in range(batch.count):
        out_rows.append(-1 if i in skip else r)
        r += i not in skip
    flat = np.zeros((r, stride), np.uint8)
    batch.pack_into(flat, out_rows, cap_n, cap_s, o_m, o_sm, o_w,
                    threads=threads)
    for i, wm in enumerate(mats):
        if out_rows[i] < 0:
            continue
        row = flat[out_rows[i]]
        n, s = wm.geno.shape
        codes = np.zeros((n, cap_s), np.uint8)
        codes[:, :s] = (wm.geno.astype(np.int16) + 1).astype(np.uint8)
        c4 = codes.reshape(n, -1, 4)
        exp = (c4[..., 0] | (c4[..., 1] << 2) | (c4[..., 2] << 4)
               | (c4[..., 3] << 6))
        got = row[:o_m].reshape(cap_n, cap_s // 4)
        check(np.array_equal(got[:n], exp) and not got[n:].any(),
              f"pack codes of window {i}")
        mb = np.unpackbits(row[o_m:o_sm], bitorder="little")[:cap_n]
        check(mb[:n].all() and not mb[n:].any(), f"pack member of {i}")
        sb = np.unpackbits(row[o_sm:o_w], bitorder="little")[:cap_s]
        check(sb[:s].all() and not sb[s:].any(), f"pack sites of {i}")
        w = row[o_w:].view(np.float32)
        check(np.array_equal(w[:s], wts[i, :s]) and (w[s:] == 1.0).all(),
              f"pack weights of {i}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m impop_tpu_torch.bench."
                                 "extract_smoke")
    ap.add_argument("--threads", type=int,
                    default=int(os.environ.get("IMPOP_EXTRACT_THREADS", "4")))
    ap.add_argument("--sanitize", choices=sorted(SANITIZERS),
                    help="load the library built with this sanitizer (its "
                         "runtime must be in LD_PRELOAD)")
    args = ap.parse_args(argv)
    threads = args.threads
    if args.sanitize:
        runtime = {"address": "libasan", "thread": "libtsan"}[args.sanitize]
        if runtime not in os.environ.get("LD_PRELOAD", ""):
            raise SystemExit(f"extract_smoke: --sanitize {args.sanitize} "
                             f"needs {runtime}.so in LD_PRELOAD")
    tmp = tempfile.mkdtemp(prefix="impop_smoke_")
    try:
        sim = simulate(tmp, ref_len=60_000, n_haps=24, site_pool=900,
                       seed=5, span=(0, 60_000))
        wins = [(lo, lo + 2000) for lo in range(0, 60_000, 2000)]
        py = PyExtractor(sim.paf_path, sim.fasta_path)
        with NativeExtractor(sim.paf_path, sim.fasta_path,
                             sanitize=args.sanitize) as nat:
            for start, end in wins[:6]:
                a = nat.extract("chr1", start, end)
                b = py.extract("chr1", start, end)
                check(a.names == b.names and a.site_keys == b.site_keys
                      and np.array_equal(a.geno, b.geno),
                      f"window {start}-{end} against the Python extractor")
            mats = nat.extract_batch("chr1", wins, threads=threads)
            for (start, end), wm in zip(wins, mats):
                one = nat.extract("chr1", start, end)
                check(wm is not None and np.array_equal(wm.geno, one.geno),
                      f"range batch {start}-{end} against one window")
            geno, member, smask, wts, _names, errors = \
                nat.extract_batch_padded("chr1", wins, threads=threads,
                                         want_weights=True)
            check(not any(errors), errors)
            for i, wm in enumerate(mats):
                n, s = wm.geno.shape
                check(np.array_equal(geno[i, :n, :s], wm.geno)
                      and member[i, :n].all() and not member[i, n:].any()
                      and smask[i, :s].all() and not smask[i, s:].any(),
                      f"padded fill of window {i}")
            batch = nat.extract_batch_open("chr1", wins, threads=threads)
            try:
                check_pack(batch, mats, wts, threads)
            finally:
                batch.close()
        # reopen: the PAF index sidecar's load path
        with NativeExtractor(sim.paf_path, sim.fasta_path,
                             sanitize=args.sanitize) as nat2:
            for start, end in wins[:3]:
                check(np.array_equal(nat2.extract("chr1", start, end).geno,
                                     py.extract("chr1", start, end).geno),
                      f"reopened window {start}-{end}")
        whole = py.extract("chr1", 0, 8000)
        check(len(split_window_matrix(whole, [(0, 4000), (4000, 8000)]))
              == 2, "split_window_matrix")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    lib = os.path.basename(load_library(sanitize=args.sanitize)._name)
    print(f"extract_smoke OK: {len(wins)} windows, threads={threads}, "
          f"library {lib}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
