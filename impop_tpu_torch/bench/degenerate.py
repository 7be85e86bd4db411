"""Degenerate batches: every CUDA kernel against its plain version on
windows and masks that real chromosomes contain and that break a kernel's
partitions first.

    python -m impop_tpu_torch.bench.degenerate [--device cuda] [-k TEXT]

A batch mixes normal HPRC-shaped windows with one degenerate kind, placed
at the first, the middle and the last window, so that block partitions
that cross windows meet it:

- ``no_site``: the site mask all False (no active site);
- ``monomorphic``: every call of every member the same allele;
- ``all_missing``: every row of the window missing (-1);
- ``no_member``: no member row, the calls left in place.

The panel stacks hold an empty panel (a ghost panel: names absent from the
pangenome) and a one-member panel beside three normal ones, side by side or
overlapping.  Each kernel takes the kinds at the shapes its design cares
about (``CASES``): N past the shared-memory caps, N not a multiple of 8
where the kernel takes any N, the streamed identity at N = 1024, the
fp32 and the 0/1 branch of the masked sums, zero weights on every active
column of a weighted window.

``run_case(name, dev)`` launches the kernel once on ``dev`` and returns
``(outputs, plain outputs, exact flags)``; ``compare`` holds them to the
tolerances of the kernel tests: integers, seeds, gid, sim and present
exact, float sums rtol 1e-5, NaN in the same places.  On CPU tensors the
wrappers take their plain versions, so a CPU run checks the batches and
the plumbing, not a kernel.  ``tests/test_torch_gpu.py`` and phase 2k of
``chip_smoke.py`` run every case on the card.
"""
from __future__ import annotations

import argparse
import sys
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

__all__ = ["KINDS", "CASES", "degenerate_windows", "degenerate_panels",
           "run_case", "compare", "main"]

KINDS = ("no_site", "monomorphic", "all_missing", "no_member")
THRESHOLD = 0.999
WIN_BP = 5000.0
RTOL, ATOL = 1e-5, 1e-6


def degenerate_rows(w: int) -> List[int]:
    """The windows that carry the degenerate kind: first, middle, last."""
    return sorted({0, w // 2, w - 1})


def degenerate_windows(seed: int, w: int, cap_n: int, cap_s: int,
                       kind: Optional[str]):
    """HPRC-shaped windows (a few haplotype classes, 0.1% noise, 2% missing
    calls, padding rows and columns) with ``kind`` (None: none) at the
    windows of :func:`degenerate_rows`.  Returns numpy (geno [w, N, S]
    int8, member [w, N] bool, site mask [w, S] bool, lengths [w] f32,
    n_hap)."""
    if kind is not None and kind not in KINDS:
        raise ValueError(f"unknown degenerate kind {kind!r}")
    rng = np.random.default_rng(seed)
    n_hap = cap_n - max(1, cap_n // 16)
    geno = np.full((w, cap_n, cap_s), -1, np.int8)
    member = np.zeros((w, cap_n), bool)
    smask = np.zeros((w, cap_s), bool)
    for wi in range(w):
        n_sites = int(rng.integers(max(1, cap_s // 6), cap_s + 1))
        classes = rng.integers(0, 2, size=(int(rng.integers(3, 12)),
                                           n_sites)).astype(np.int8)
        g = classes[rng.integers(0, len(classes), size=n_hap)]
        g = np.where(rng.random(g.shape) < 0.001, 1 - g, g)
        g[rng.random(g.shape) < 0.02] = -1
        geno[wi, :n_hap, :n_sites] = g
        member[wi, :n_hap] = True
        smask[wi, :n_sites] = True
    for wi in degenerate_rows(w) if kind else []:
        if kind == "no_site":
            smask[wi] = False
        elif kind == "monomorphic":
            geno[wi] = np.where(geno[wi] >= 0, 1, -1)
        elif kind == "all_missing":
            geno[wi] = -1
        else:
            member[wi] = False
    lengths = np.full(w, WIN_BP, np.float32)
    return geno, member, smask, lengths, n_hap


def degenerate_panels(seed: int, w: int, cap_n: int, n_hap: int,
                      overlapping: bool) -> np.ndarray:
    """[w, 5, N] bool: an empty panel, a one-member panel and three normal
    panels (side by side, or drawn at random so that they overlap each
    other and the one member)."""
    rng = np.random.default_rng(seed + 1)
    pm = np.zeros((w, 5, cap_n), bool)
    one = int(rng.integers(0, n_hap))
    pm[:, 1, one] = True
    if overlapping:
        pm[:, 2:, :n_hap] = rng.random((w, 3, n_hap)) < 0.4
        pm[:, 2, one] = True
    else:
        rest = [i for i in range(n_hap) if i != one]
        for k, part in enumerate(np.array_split(rest, 3)):
            pm[:, 2 + k, part] = True
    return pm


# ------------------------------------------------------------------ cases


class Case(NamedTuple):
    kernel: str          # the wrapper's name in impop_tpu_torch.ops
    kind: str            # a member of KINDS, or a kernel-specific kind
    w: int
    n: int
    s: int
    variant: str         # "disjoint" / "overlap", "01" / "fp32", "" ...

    @property
    def name(self) -> str:
        tail = f"-{self.variant}" if self.variant else ""
        return f"{self.kernel}-{self.kind}-{self.n}x{self.s}x{self.w}{tail}"


def _cases() -> List[Case]:
    out = []
    for kind in KINDS:
        for w, n, s in ((8, 512, 128), (4, 1152, 128)):
            for v in ("disjoint", "overlap"):
                out.append(Case("window_stats", kind, w, n, s, v))
    for kind in KINDS:
        out.append(Case("seed_peel", kind, 4, 512, 128, ""))
    for kind in ("no_carrier", "one_carrier", "monomorphic", "no_member"):
        for w, n, s in ((8, 512, 128), (5, 37, 70), (3, 1000, 200)):
            out.append(Case("ehh_area", kind, w, n, s, ""))
    for kind in KINDS:
        for w, n, s in ((8, 512, 128), (2, 1024, 2048), (3, 37, 37),
                        (3, 1000, 300)):
            out.append(Case("pairwise_identity", kind, w, n, s, ""))
    for kind in KINDS + ("zero_weights",):
        for w, n, s in ((8, 512, 128), (2, 1024, 2048), (3, 37, 37)):
            out.append(Case("pairwise_identity_weighted", kind, w, n, s, ""))
    for kind in ("empty_rows", "no_present"):
        for w, n in ((8, 512), (3, 37), (3, 1000)):
            for v in ("01", "fp32"):
                out.append(Case("masked_pair_sums", kind, w, n, 128, v))
    for kind in KINDS:
        for v in ("disjoint", "overlap"):
            out.append(Case("identity_group", kind, 8, 512, 128, v))
    return out


CASES: Dict[str, Case] = {c.name: c for c in _cases()}


def _pairs(p: int) -> Tuple[tuple, tuple]:
    pairs = [(i, j) for i in range(p) for j in range(i + 1, p)]
    return tuple(a for a, _ in pairs), tuple(b for _, b in pairs)


def _window_args(c: Case, dev):
    import torch

    seed = 1000 + sum(map(ord, c.name))
    # the kernel-specific kinds start from normal windows
    geno, member, smask, lengths, n_hap = degenerate_windows(
        seed, c.w, c.n, c.s, c.kind if c.kind in KINDS else None)
    pm = degenerate_panels(seed, c.w, c.n, n_hap, c.variant == "overlap")
    ts = [torch.from_numpy(a).to(dev)
          for a in (geno, member, smask, lengths, pm)]
    return ts, n_hap, seed


def _window_stats(c: Case, dev):
    from impop_tpu_torch.ops.windowstat import (window_stats,
                                                window_stats_plain)
    from impop_tpu_torch.stats.panelstats import panel_mask_stack

    (g, m, sm, ln, pm), _, _ = _window_args(c, dev)
    disjoint = c.variant == "disjoint"
    pa, pb = _pairs(pm.shape[-2])
    stack, ma, mb = panel_mask_stack(pm, m, pa, pb, disjoint)
    args = (g, m, sm, stack, ma, mb, THRESHOLD, ln, pa, pb, disjoint)
    got, want = window_stats(*args), window_stats_plain(*args)
    ints = ("n", "num_groups", "pairs_used2", "cnt_aa", "cnt_bb", "cnt_ab",
            "s", "seed_risk")
    keys = ints + ("quad", "sum_aa", "sum_bb", "sum_ab", "gdxy")
    return ([got[k] for k in keys], [want[k] for k in keys],
            [k in ints for k in keys])


def _identity_inputs(c: Case, dev):
    from impop_tpu_torch.ops.pairdiff import pairwise_identity_plain

    (g, m, sm, ln, pm), n_hap, seed = _window_args(c, dev)
    sim, present = pairwise_identity_plain(g, m, sm, ln)
    return g, m, sm, ln, pm, sim, present, n_hap, seed


def _seed_peel(c: Case, dev):
    import torch

    from impop_tpu_torch.ops.seedpeel import seed_gid_plain, seed_peel

    g, m, sm, ln, pm, sim, present, n_hap, seed = _identity_inputs(c, dev)
    # 20 masks: the five panels, then random ones over all rows
    rng = np.random.default_rng(seed + 2)
    extra = torch.from_numpy(rng.random((c.w, 15, c.n)) < 0.5).to(dev)
    masks = torch.cat([pm, extra], dim=-2)
    got = seed_peel(sim, present, m, masks, THRESHOLD)
    want = seed_gid_plain(sim, present, m, masks, THRESHOLD)
    return list(got), list(want), [True, True]


def _ehh_area(c: Case, dev):
    import torch

    from impop_tpu_torch.ops.ehhdeath import ehh_area, ehh_area_plain

    seed = 1000 + sum(map(ord, c.name))
    geno, member, smask, _, n_hap = degenerate_windows(
        seed, c.w, c.n, c.s, c.kind if c.kind in KINDS else None)
    focal = np.zeros(c.w, np.int32)
    for wi in range(c.w):
        act = np.nonzero(smask[wi])[0]
        focal[wi] = act[len(act) // 2]
    rng = np.random.default_rng(seed + 3)
    for wi in degenerate_rows(c.w):
        col = geno[wi, :, focal[wi]]
        if c.kind == "no_carrier":       # no member carries allele 1
            col[col == 1] = 0
        elif c.kind == "one_carrier":    # exactly one member carries it
            col[col == 1] = 0
            col[int(rng.integers(0, n_hap))] = 1
    args = [torch.from_numpy(a).to(dev) for a in (geno, member, smask, focal)]
    got, want = ehh_area(*args), ehh_area_plain(*args)
    return list(got), list(want), [True, True]


def _pairwise(c: Case, dev):
    import torch

    from impop_tpu_torch.ops.pairdiff import (
        pairwise_identity, pairwise_identity_plain,
        pairwise_identity_weighted, pairwise_identity_weighted_plain)

    (g, m, sm, ln, _), _, seed = _window_args(c, dev)
    if c.kernel == "pairwise_identity":
        got = pairwise_identity(g, m, sm, ln)
        want = pairwise_identity_plain(g, m, sm, ln)
    else:
        rng = np.random.default_rng(seed + 4)
        wts = rng.integers(1, 51, size=(c.w, c.s)).astype(np.float32)
        wts[:, c.s // 5] = 100_000.0
        if c.kind == "zero_weights":
            for wi in degenerate_rows(c.w):
                wts[wi][sm[wi].cpu().numpy()] = 0.0
        wt = torch.from_numpy(wts).to(dev)
        got = pairwise_identity_weighted(g, m, sm, ln, wt)
        want = pairwise_identity_weighted_plain(g, m, sm, ln, wt)
    return list(got), list(want), [True, True]


def _masked_pair_sums(c: Case, dev):
    import torch

    from impop_tpu_torch.ops.panelquad import (masked_pair_sums,
                                               masked_pair_sums_plain)

    g, m, sm, ln, pm, sim, present, n_hap, seed = _identity_inputs(c, dev)
    rng = np.random.default_rng(seed + 5)
    r = 6
    wd = (rng.random((c.w, r, c.n)) * (rng.random((c.w, r, c.n)) < 0.4))
    wp = (rng.random((c.w, r, c.n)) < 0.3).astype(np.float32)
    # row 0 empty (a ghost panel), row 1 one-hot (a one-member panel)
    wd[:, 0] = wp[:, 0] = 0.0
    wd[:, 1] = wp[:, 1] = 0.0
    one = int(rng.integers(0, n_hap))
    wd[:, 1, one] = wp[:, 1, one] = 1.0
    if c.variant == "fp32":
        wp[:, r - 1] = rng.random(c.n) * 3.0
    if c.kind == "no_present":
        rows = torch.tensor(degenerate_rows(c.w), device=dev)
        present = present.clone()
        present[rows] = False
    wd, wp = (torch.from_numpy(a.astype(np.float32)).to(dev)
              for a in (wd, wp))
    got = masked_pair_sums(sim, present, wd, wp)
    want = masked_pair_sums_plain(sim, present, wd, wp)
    exact_p = c.variant == "01"         # 0/1 rows of Wp: popcounts
    return list(got), list(want), [False, exact_p]


def _identity_group(c: Case, dev):
    from impop_tpu_torch.ops.idgroup import (identity_group,
                                             identity_group_plain)
    from impop_tpu_torch.stats.panelstats import panel_mask_stack

    (g, m, sm, ln, pm), _, _ = _window_args(c, dev)
    pa, pb = _pairs(pm.shape[-2])
    # R = 5 panels + 10 unions = 15 rows side by side (the empty panel
    # among them), 5 + 30 overlapping
    stack = panel_mask_stack(pm, m, pa, pb, c.variant == "disjoint")[0]
    got = identity_group(g, m, sm, stack, THRESHOLD, ln)
    want = identity_group_plain(g, m, sm, stack, THRESHOLD, ln)
    return list(got), list(want), [True, True, True, True]


_RUNNERS: Dict[str, Callable] = {
    "window_stats": _window_stats, "seed_peel": _seed_peel,
    "ehh_area": _ehh_area, "pairwise_identity": _pairwise,
    "pairwise_identity_weighted": _pairwise,
    "masked_pair_sums": _masked_pair_sums,
    "identity_group": _identity_group}


def run_case(name: str, dev):
    """Launch case ``name``'s kernel once on ``dev`` and its plain version;
    returns (outputs, plain outputs, exact flags), synchronised."""
    import torch

    c = CASES[name]
    got, want, exact = _RUNNERS[c.kernel](c, dev)
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
    return got, want, exact


def compare(got, want, exact, tag: str) -> float:
    """Exact outputs equal, the others within rtol 1e-5 (atol 1e-6), NaN in
    the same places.  Returns the max abs error; raises AssertionError."""
    import torch

    worst = 0.0
    for i, (g, w, ex) in enumerate(zip(got, want, exact)):
        if g.shape != w.shape:
            raise AssertionError(f"{tag}: output {i} shape "
                                 f"{tuple(g.shape)} vs {tuple(w.shape)}")
        gd, wd = g.detach().double().cpu(), w.detach().double().cpu()
        nan_g, nan_w = torch.isnan(gd), torch.isnan(wd)
        if not torch.equal(nan_g, nan_w):
            raise AssertionError(f"{tag}: output {i} NaN in other places")
        gd, wd = gd.masked_fill(nan_g, 0.0), wd.masked_fill(nan_w, 0.0)
        err = float((gd - wd).abs().max()) if gd.numel() else 0.0
        worst = max(worst, err)
        if ex and not torch.equal(gd, wd):
            raise AssertionError(f"{tag}: output {i} differs (max abs "
                                 f"{err})")
        if not torch.allclose(gd, wd, rtol=RTOL, atol=ATOL):
            raise AssertionError(f"{tag}: output {i} max abs err {err} "
                                 f"beyond rtol {RTOL}")
    return worst


def main(argv=None) -> int:
    from impop_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser(
        prog="python -m impop_tpu_torch.bench.degenerate")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("-k", default="", help="run the cases whose name holds "
                                           "this text")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    names = [n for n in CASES if args.k in n]
    for name in names:
        err = compare(*run_case(name, dev), name)
        print(f"{name}: ok, max abs err {err:.3e}", flush=True)
    print(f"degenerate: {len(names)} cases on {dev}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
