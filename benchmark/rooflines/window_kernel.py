"""The whole-window kernel (events identity, ``ops/windowstat`` ->
``csrc/windowstat.cu``, five launches): a window of N members and S sites
with P panels and Q pairs.

- identity: the differing sites of every pair, S·N(N−1)/2 pair-sites, a
  multiply-add each (2 int8 operations);
- value products, float32, a multiply-add per ordered pair of a
  quadratic form: grouped π of each panel (g_p² over its g_p group seeds)
  and of each pair's union (g_u²), Hudson's within-a, within-b and
  between sums over members (n_a², n_b², n_a·n_b) and the grouped between
  sum (g_a·g_b);
- the presence counts of Hudson's three sums, 0/1, int8;
- bytes: the allele tile (N·S int8) and the panel bitmasks in, the row of
  statistics out (4 bytes a value).
"""
from benchmark.rooflines import groups, masks, per_window

KERNELS = ("window_pack_kernel", "window_pairs_kernel", "window_peel_kernel",
           "window_products_kernel", "window_dots_kernel")


def _hudson(a, b):
    """Hudson's within-a, within-b and between sums of one pair."""
    return a * a + b * b + a * b


def work(run):
    i8 = f32 = nbytes = 0.0
    for w, f, k in per_window(run):
        n, s = f["geno"].shape
        sizes, pairs = masks(run, f)
        seeds, union = groups(run, w)
        quad = sum(g * g for g in seeds)
        hud = 0
        for (a, b), (pa, pb), gu in zip(pairs, run.truth.pairs, union):
            hud += _hudson(a, b)
            quad += gu * gu + _hudson(a, b) + seeds[pa] * seeds[pb]
        i8 += k * (s * n * (n - 1) + 2 * hud)
        f32 += k * 2 * quad
        row = 2 * len(sizes) + 3 * len(pairs) + 3
        nbytes += k * (n * s + len(sizes) * n / 8 + 4 * row)
    return {"int8": i8, "fp32": f32}, nbytes
