"""The weighted identity (columns mode, ``ops/pairdiff`` ->
``csrc/pairdiff.cu`` ``weighted_gram_kernel`` and its split reduce): for a
window of N members and S sites, every pair's column-weighted differing
sites (S·N(N−1)/2 pair-sites, a float32 multiply-add each) and compared
sites (0/1, int8); the allele tile (N·S int8) and the S float32 weights
in, sim (float32) and present (one byte) out for the N×N pairs."""
from benchmark.rooflines import per_window

KERNELS = ("weighted_gram_kernel", "weighted_reduce_kernel")


def work(run):
    i8 = f32 = nbytes = 0.0
    for _, f, k in per_window(run):
        n, s = f["geno"].shape
        f32 += k * s * n * (n - 1)
        i8 += k * s * n * (n - 1)
        nbytes += k * (n * s + 4 * s + 5 * n * n)
    return {"int8": i8, "fp32": f32}, nbytes
