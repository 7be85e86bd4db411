"""Where the time of the identity Gram kernel goes, on the card.

    python -m impop_tpu_torch.bench.gram_breakdown

Builds variants of ``csrc/pairdiff.cu`` with one part of the unit-weight
kernel (``unit_gram_kernel``: TMA boxes in flight, every warp decoding
the next stage while two warpgroups' ``wgmma`` run) taken out
(text substitutions on the source; the results of a variant are wrong by
design and are not checked), launches each through its C entry point with
one site split, and prints the device time of each (CUDA graph replays,
median of 10) at [512, 64] x 64 (almost all epilogue) and [512, 2048] x 64
(the main path's shape of the long-window kernel).  A part's cost is the
base time minus the variant's; parts that overlap cost less than their
sum.

  base       the kernel as built for the port
  nodiv      the epilogue's exact division replaced by one multiply
  nomirror   no (j, i) mirror writes
  nostores   no global stores (staging in shared memory only)
  noepi      no epilogue at all (one word per block)
  nodecode   no decode after the first stage (the wgmmas read stale tiles)
  nomma      no matrix math (the consumer still waits and releases)
  loadsonly  neither decode nor matrix math: loads, barriers, epilogue
"""
from __future__ import annotations

import ctypes
import os
import sys
import tempfile

_DECODE = ("      decode_stage(smem + slot * kRawSlot, smem + kDecOff + ((t + 1) & 1) * "
           "kDecSlot,\n")
_MMA = ("      wgmma_s8(zacc, operand_desc(zi + 2 * kLbo * kk), "
        "operand_desc(zj + 2 * kLbo * kk));\n"
        "      wgmma_s8(vacc, operand_desc(vi + 2 * kLbo * kk), "
        "operand_desc(vj + 2 * kLbo * kk));\n")
_EPI = "    unit_epilogue(zacc, vacc, smem, a, k);\n    return;\n"
_STAGED = "  __syncthreads();\n\n  const size_t base = static_cast<size_t>(k.w)"

VARIANTS = {
    "base": [],
    "nodiv": [("div_rn(diff, len, inv)", "(diff * inv)")],
    "nomirror": [("  if (k.diag) return;\n", "  return;\n")],
    "nostores": [(_STAGED, "  __syncthreads();\n  if (n > 0) return;\n"
                  "\n  const size_t base = static_cast<size_t>(k.w)")],
    "noepi": [(_EPI, "    if (threadIdx.x == 0) a.sim[k.w] = zacc[0] + vacc[63];\n"
               "    return;\n")],
    "nodecode": [(_DECODE, "      if (a.n < 0) decode_stage(smem + slot * kRawSlot, "
                  "smem + kDecOff,\n")],
    "nomma": [(_MMA, "      (void)vj;\n")],
    "loadsonly": [(_DECODE, "      if (a.n < 0) decode_stage(smem + slot * kRawSlot, "
                   "smem + kDecOff,\n"), (_MMA, "      (void)vj;\n")],
}
SHAPES = ((64, 512, 64), (64, 512, 2048))


def build(work: str) -> dict:
    from impop_tpu_torch.bench import build_variants

    libs = build_variants("pairdiff.cu", VARIANTS, work)
    for lib in libs.values():
        lib.impop_pairwise_identity.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4)
    return libs


def main() -> int:
    import numpy as np
    import torch

    from impop_tpu_torch.bench import graph_ms
    from impop_tpu_torch.ops.pairdiff import KT_UNIT

    if not torch.cuda.is_available():
        print("gram_breakdown: needs a CUDA device", file=sys.stderr)
        return 2
    from impop_tpu_torch.bench.roofline import nvidia_smi_line

    smi = nvidia_smi_line()
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
                        lens.data_ptr(), w, n, s, 1, -(-s // KT_UNIT), None,
                        sim.data_ptr(), pres.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                row.append(f"{name} {graph_ms(run):.4f}")
            print(f"[{n},{s}]x{w}: " + ", ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
