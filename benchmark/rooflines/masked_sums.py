"""The masked panel sums (``ops/panelquad`` -> ``csrc/panelquad.cu``
``masked_rows_pack_kernel`` and ``masked_pair_sums_kernel``): for a window
of N members, the products of (1 − sim) and of present with the statistics'
weight rows: a row for the grouped π of each panel and pair union (nonzero
on its group seeds), and Hudson's side rows a and b of each pair (nonzero
on their members).  Each row multiplies only its nonzeros, N of
(1 − sim) for each (a float32 multiply-add; the present counts of the 0/1
rows, int8); sim (float32) and present (one byte) read once, the rows in
and their N products out (float32)."""
from benchmark.rooflines import groups, masks, per_window


KERNELS = ("masked_rows_pack_kernel", "masked_pair_sums_kernel")


def work(run):
    i8 = f32 = nbytes = 0.0
    for w, f, k in per_window(run):
        n = f["geno"].shape[0]
        _, pairs = masks(run, f)
        seeds, union = groups(run, w)
        rows = seeds + union + [v for ab in pairs for v in ab]
        f32 += k * 2 * n * sum(rows)
        i8 += k * 2 * n * sum(rows)
        nbytes += k * (5 * n * n + 2 * 4 * n * 2 * len(rows))
    return {"int8": i8, "fp32": f32}, nbytes
