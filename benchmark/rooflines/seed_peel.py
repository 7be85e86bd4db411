"""The seed peel (``ops/seedpeel`` -> ``csrc/windowstat.cu``
``seed_link_kernel`` and ``seed_peel_kernel``): for a window of N members
and M masks (each panel and each pair's union, one call for all of them),
the links j < i (sim > threshold, present): the strict upper triangles of
sim (float32) and present (one byte) read once, a float32 compare each;
the member row and the M masks in (one byte a row), and each mask's seeds
(one byte) and group ids (int32) out.  The walk over the link words is
integer work on shared memory, far below the bytes' time, and is not
counted."""
from benchmark.rooflines import per_window

KERNELS = ("seed_link_kernel", "seed_peel_kernel")


def work(run):
    f32 = nbytes = 0.0
    for _, f, k in per_window(run):
        n = f["geno"].shape[0]
        masks = f["masks"].shape[0] + len(run.truth.pairs)
        tri = n * (n - 1) / 2
        f32 += k * tri
        nbytes += k * (5 * tri + n + masks * n + 5 * masks * n)
    return {"fp32": f32}, nbytes
