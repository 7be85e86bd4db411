"""The formulations of the pairwise identity, timed side by side.

    python -m impop_tpu_torch.bench.pairwise [--device cuda|cpu] [--n 512]
        [--s 8192] [--windows 1] [--reps 16]

At the long-window shape ([n, s] = [512, 8192], bench.py's long-window
tiles, seed 7) it times

  unit        ``ops.pairdiff.pairwise_identity`` (``unit_gram_kernel``,
              int8 ``wgmma``)
  weighted    ``ops.pairdiff.pairwise_identity_weighted`` with unit
              weights (``weighted_gram_kernel``, bf16 ``mma.sync``)
  bmm-bf16    one bf16 ``torch.bmm`` of the stacked ±1/0 operands [z; v]
              (the Grams alone, a yardstick the port never calls)
  fp32-torch  ``stats.allele.pairwise_diff`` (fp32 matmuls, TF32 off)

each beside its bound (``bench.roofline``: bytes in and out over the
memory rate, or its Grams' operations over the peak of the type it runs).
On the card the times are CUDA graph replays (``bench.graph_ms``, the
median of ``--reps``); with ``--device cpu`` host-clock medians of the
plain versions.  The identities must agree: the kernels' sim and present
equal the fp32 route's (the yardstick's bf16 Grams are only timed).
The twin of the repository's ``tools/bench_pairwise.py``.
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time

from impop_tpu_torch.bench import inputs


def timer(dev, reps):
    """ms of one fn() on ``dev``: CUDA graph replays on the card, the
    host clock's median elsewhere."""
    if dev.type == "cuda":
        from impop_tpu_torch.bench import graph_ms

        return lambda fn: graph_ms(fn, reps)

    def host_ms(fn):
        fn()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times)
    return host_ms


def zv_operands(geno, member, smask):
    """The stacked ±1/0 bf16 operands [z; v] of the unit-weight Grams,
    [2W, N, S]: diff = (v·vᵀ − z·zᵀ) / 2."""
    import torch

    valid = (geno >= 0) & member[..., :, None] & smask[..., None, :]
    v = valid.to(torch.bfloat16)
    z = torch.where(valid, 2 * geno.clamp(min=0) - 1, 0).to(torch.bfloat16)
    return torch.cat([z, v], 0)


def main(argv=None) -> int:
    import torch

    from impop_tpu_torch.bench.main import LONG_BP, long_inputs
    from impop_tpu_torch.bench.roofline import bound, nbytes
    from impop_tpu_torch.device import resolve_device
    from impop_tpu_torch.ops.pairdiff import (pairwise_identity,
                                              pairwise_identity_weighted)
    from impop_tpu_torch.stats.allele import identity_epilogue, pairwise_diff

    ap = argparse.ArgumentParser(prog="python -m impop_tpu_torch.bench."
                                 "pairwise")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--s", type=int, default=8192)
    ap.add_argument("--windows", type=int, default=1)
    ap.add_argument("--reps", type=int, default=16)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n, s, w = args.n, args.s, args.windows
    g, m, sm = inputs.to_dev(dev, *long_inputs(n, s, w))
    length = torch.full((w,), LONG_BP, device=dev)
    ones = torch.ones((w, s), device=dev)
    x = zv_operands(g, m, sm)
    xt = x.transpose(1, 2).contiguous()

    sim, pres = pairwise_identity(g, m, sm, length)
    sim_w, pres_w = pairwise_identity_weighted(g, m, sm, length, ones)
    diff, compared = pairwise_diff(g, m, sm)
    sim_f, pres_f = identity_epilogue(diff, compared, m, length)
    for tag, a, b in (("weighted sim", sim_w, sim), ("fp32 sim", sim_f, sim),
                      ("weighted present", pres_w, pres),
                      ("fp32 present", pres_f, pres)):
        if not torch.equal(a, b):
            print(f"pairwise: {tag} differs from the unit kernel's "
                  f"(max abs {float((a.float() - b.float()).abs().max())})",
                  file=sys.stderr)
            return 1

    tri = w * n * (n + 1) // 2 * s
    full = w * n * n * s
    io = nbytes(g, m, sm, length, sim, pres)
    cands = {
        "unit": (lambda: pairwise_identity(g, m, sm, length),
                 bound(io, int8=4 * tri)),
        "weighted": (lambda: pairwise_identity_weighted(g, m, sm, length,
                                                        ones),
                     bound(io + nbytes(ones), bf16=4 * tri, int8=2 * tri)),
        "bmm-bf16": (lambda: torch.bmm(x, xt),
                     bound(nbytes(x) + 2 * w * n * n * 2, bf16=4 * full)),
        "fp32-torch": (lambda: pairwise_diff(g, m, sm),
                       bound(nbytes(g, m, sm, diff, compared),
                             fp32=6 * full)),
    }
    ms_of = timer(dev, args.reps)
    where = dev.type
    if dev.type == "cuda":
        from impop_tpu_torch.bench.roofline import nvidia_smi_line

        where = nvidia_smi_line()
    clock = ("CUDA graph replays" if dev.type == "cuda"
             else "host clock, plain versions")
    gcells = n * n * s / 1e9
    for name, (fn, (b_ms, by)) in cands.items():
        ms = ms_of(fn)
        share = (f", {100 * b_ms / ms:.1f}% of it" if dev.type == "cuda"
                 else "")
        print(f"{name:10s} [{n},{s}]x{w}: {ms:.4f} ms ({clock}; "
              f"{w * gcells / (ms / 1e3):.0f} Gcells/s); H100 bound "
              f"{b_ms:.4f} ms ({by}){share} [{where}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
