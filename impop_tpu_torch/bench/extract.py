"""The extraction layer timed alone, on the host.

    python -m impop_tpu_torch.bench.extract [--ref-len 1000000]
        [--per-call 320] [--threads 1 2 4] [--passes 3]

Simulates the e2e regime's pangenome shape (465 haplotypes beside the
reference, 5 kb windows, a shared site pool of one site per 60 bp) and
times ``impop_tpu_torch.extract.NativeExtractor``'s range extraction in
calls of ``--per-call`` windows, then extraction plus the threaded wire
pack (``NativeBatch.pack_into``, the scan's hot path) at each
``--threads``, best of ``--passes`` interleaved passes.  Imports no
torch.  The twin of the repository's ``tools/bench_extract.py``.
"""
from __future__ import annotations

import argparse
import shutil
import sys
import tempfile
import time

import numpy as np

from impop_tpu_torch.extract import NativeExtractor
from impop_tpu_torch.extract.simulate import simulate
from impop_tpu_torch.hostio import _scan_buf_layout

WIN_BP = 5000
UNIT_WINDOWS = 40


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m impop_tpu_torch.bench."
                                 "extract")
    ap.add_argument("--ref-len", type=int, default=1_000_000)
    ap.add_argument("--per-call", type=int, default=320)
    ap.add_argument("--threads", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--passes", type=int, default=3)
    args = ap.parse_args(argv)
    ref_len, per_call = args.ref_len, args.per_call
    tmp = tempfile.mkdtemp(prefix="impop_xbench_")
    try:
        t0 = time.perf_counter()
        sim = simulate(tmp, ref_len=ref_len, n_haps=465,
                       site_pool=ref_len // 60, seed=11, span=(0, ref_len))
        t_sim = time.perf_counter() - t0
        t0 = time.perf_counter()
        ex = NativeExtractor(sim.paf_path, sim.fasta_path)
        t_open = time.perf_counter() - t0
        wins = [(lo, lo + WIN_BP) for lo in range(0, ref_len, WIN_BP)]
        chunks = [wins[lo:lo + per_call]
                  for lo in range(0, len(wins), per_call)]
        try:
            n_sites = 0
            t0 = time.perf_counter()
            for chunk in chunks:
                mats = ex.extract_batch(sim.ref_name, chunk)
                n_sites += sum(len(m.site_keys) for m in mats
                               if m is not None)
            dt = time.perf_counter() - t0
            print(f"simulate: {t_sim:.2f}s  open(index): {t_open:.2f}s")
            print(f"extract: {len(wins)} windows in {dt:.3f}s = "
                  f"{len(wins) / dt:.1f} win/s "
                  f"({len(wins) / dt / UNIT_WINDOWS:.2f} 200kb-units/s); "
                  f"{n_sites} sites total")

            def one_pass(threads: int) -> float:
                t0 = time.perf_counter()
                for chunk in chunks:
                    nb = ex.extract_batch_open(sim.ref_name, chunk,
                                               threads=threads)
                    try:
                        cap_n = -(-max(n for n, _ in nb.dims) // 128) * 128
                        cap_s = -(-max(s for _, s in nb.dims) // 128) * 128
                        lay = _scan_buf_layout(cap_n, cap_s, 5, False)
                        flat = np.zeros((len(chunk), lay["total"]),
                                        np.uint8)
                        nb.pack_into(flat, list(range(len(chunk))), cap_n,
                                     cap_s, lay["m"], lay["sm"], -1, threads)
                    finally:
                        nb.close()
                return len(wins) / (time.perf_counter() - t0)

            rates = {t: [] for t in args.threads}
            for _ in range(args.passes):
                for t in args.threads:
                    rates[t].append(one_pass(t))
        finally:
            ex.close()
        print(f"\nextract + wire pack by threads (win/s, best of "
              f"{args.passes}):")
        for t in args.threads:
            print(f"  threads={t}: {max(rates[t]):8.1f} win/s (passes: "
                  f"{', '.join(f'{r:.0f}' for r in rates[t])})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
