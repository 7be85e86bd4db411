"""EHH decay areas (``ops/ehhdeath`` -> ``csrc/ehhdeath.cu``
``ehh_pack_kernel`` and ``ehh_pairs_kernel``): for a window of N members
and S sites, the allele tile (N·S int8) and the focal column in, four
values out.  The walks compare each pair of one allele's carriers site by
site away from the focal until they differ: at most S·N(N−1)/2
comparisons (int8), whose time at the int8 peak is below the bytes' time
at these shapes, so the bytes bound the kernel either way; the count
takes that most."""
from benchmark.rooflines import per_window

KERNELS = ("ehh_pack_kernel", "ehh_pairs_kernel")


def work(run):
    i8 = nbytes = 0.0
    for _, f, k in per_window(run):
        n, s = f["geno"].shape
        i8 += k * s * n * (n - 1) / 2
        nbytes += k * (n * s + 4 + 16)
    return {"int8": i8}, nbytes
