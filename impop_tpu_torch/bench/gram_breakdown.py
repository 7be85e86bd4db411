"""Where the time of the identity Gram kernel goes, on the card.

    python -m impop_tpu_torch.bench.gram_breakdown

Builds variants of ``csrc/pairdiff.cu`` with one part of the unit-weight
kernel taken out (text substitutions on the source; the results of a
variant are wrong by design and are not checked), launches each through
its C entry point with one site split, and prints the device time of each
(CUDA graph replays, median of 10) at [512, 64] x 64 (almost all
epilogue) and [512, 2048] x 64 (the main path's shape of the long-window
kernel).  A part's cost is the base time minus the variant's.

  base       the kernel as built for the port
  nodiv      the epilogue's exact division replaced by one multiply
  nomirror   no (j, i) mirror writes
  nostores   no global stores (staging in shared memory only)
  noepi      no epilogue at all (one word per block)
  nodecode   no decode of the int8 tiles (the MMAs read stale tiles)
  nomma      no matrix math
  loadsonly  neither decode nor matrix math: loads, barriers, epilogue
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

_DECODE = "      else decode_unit(smem, (t + 1) % kStages, next, diag, tid);\n"
_MMA_A = ("    if (!decode_first) mma_stage(acc, cur, diag, row0, col0, lane, "
          "pieces);\n")
_MMA_B = ("    if (decode_first) mma_stage(acc, cur, diag, row0, col0, lane, "
          "pieces);\n")
_KEEP = "    if (decode_first && cur[tid] == 77) acc.d[0][0][0] += 1;\n"

VARIANTS = {
    "base": [],
    "nodiv": [("div_rn(diff, len, inv)", "(diff * inv)")],
    "nomirror": [("  if (ti == tj) return;\n", "  return;\n")],
    "nostores": [("  const size_t base = static_cast<size_t>(w) * n * n;\n",
                  "  if (n > 0) return;\n"
                  "  const size_t base = static_cast<size_t>(w) * n * n;\n")],
    "noepi": [("    epilogue<kW>(acc, smem, a, w, ti, tj);\n    return;\n",
               "    if (tid == 0) a.sim[w] = acc.d[0][0][0] + acc.v[1][2][3];\n"
               "    return;\n")],
    "nodecode": [(_DECODE, "      else (void)next;\n")],
    "nomma": [(_MMA_A, ""), (_MMA_B, _KEEP)],
    "loadsonly": [(_DECODE, "      else (void)next;\n"), (_MMA_A, ""),
                  (_MMA_B, _KEEP)],
}
SHAPES = ((64, 512, 64), (64, 512, 2048))


def build(work: str) -> dict:
    from impop_tpu_torch.ops._build import NVCC_FLAGS, _CSRC, nvcc_path

    with open(os.path.join(_CSRC, "pairdiff.cu")) as fh:
        src = fh.read()
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer has {old!r}")
            text = text.replace(old, new)
        path = os.path.join(work, f"{name}.cu")
        with open(path, "w") as fh:
            fh.write(text)
        procs[name] = subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-shared", "-o",
             os.path.join(work, f"{name}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        lib = ctypes.CDLL(os.path.join(work, f"{name}.so"))
        lib.impop_pairwise_identity.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4)
        libs[name] = lib
    return libs


def main() -> int:
    import numpy as np
    import torch

    from impop_tpu_torch.bench import graph_ms

    if not torch.cuda.is_available():
        print("gram_breakdown: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    from impop_tpu_torch.ops._build import _BUILD

    os.makedirs(_BUILD, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_BUILD) as work:
        libs = build(work)
        dev = torch.device("cuda")
        rng = np.random.default_rng(1)
        print(f"gram_breakdown on {smi}: device ms (CUDA graph replays, "
              "median of 10), one site split")
        for w, n, s in SHAPES:
            geno = rng.integers(-1, 2, (w, n, s)).astype(np.int8)
            g = torch.from_numpy(geno).to(dev)
            mem = torch.ones((w, n), dtype=torch.uint8, device=dev)
            smk = torch.ones((w, s), dtype=torch.uint8, device=dev)
            lens = torch.full((w,), 200_000.0, device=dev)
            sim = torch.empty((w, n, n), device=dev)
            pres = torch.empty((w, n, n), dtype=torch.uint8, device=dev)
            row = []
            for name, lib in libs.items():
                def run(lib=lib):
                    err = lib.impop_pairwise_identity(
                        g.data_ptr(), mem.data_ptr(), smk.data_ptr(),
                        lens.data_ptr(), w, n, s, 1, -(-s // 64), None,
                        sim.data_ptr(), pres.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                row.append(f"{name} {graph_ms(run):.4f}")
            print(f"[{n},{s}]x{w}: " + ", ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
