"""The whole-window program: identity, S, greedy grouping, group weights,
every panel and pair reduction and ``seed_risk`` for a batch of windows
(port of ``impop_tpu.ops.windowstat.window_stats_pallas``).

- :func:`window_stats_plain`: ``pairwise_identity_plain`` + the panel
  reduction of ``fused_panel_stats``, returning the raw row-dots.
- :func:`window_stats`: the wrapper.  CPU tensors take the plain version;
  CUDA tensors launch ``window_stats_kernel`` of ``csrc/windowstat.cu``
  (five launches, many blocks per window; see the source for its
  design), or raise.  :func:`window_kernel_fits` says which caps it
  takes; ``stats.panelstats.fused_window_stats`` composes the others.

Both return the dict ``window_stats_pallas`` returns, with a leading window
axis: quad/n/num_groups [W, R], pairs_used2 [W, PQ], sum/cnt aa, bb, ab and
gdxy [W, Q] (unscaled row-dots), s [W] and seed_risk [W] (0/1), all f32.
"""
from __future__ import annotations

import functools
import math

import torch

from impop_tpu_torch.device import on_device
from impop_tpu_torch.ops.pairdiff import pairwise_identity_plain
from impop_tpu_torch.ops.seedpeel import seed_gid_plain
from impop_tpu_torch.stats.allele import segregating_sites
from impop_tpu_torch.stats.panelstats import gdxy_rows, panel_sums

__all__ = ["window_stats", "window_stats_plain", "window_kernel_fits",
           "out_layout"]

_GROUP = 16          # the X stacks are padded to multiples of 16 rows
_COL_TILE = 64       # Y columns per block of the kernel's phase C
MAX_SITES = 65535    # the kernel keeps each pair's diff count in 16 bits
_Q_KEYS = ("sum_aa", "cnt_aa", "sum_bb", "cnt_bb", "sum_ab", "cnt_ab",
           "gdxy")


def window_kernel_fits(n_cap: int, s_cap: int) -> bool:
    """Whether ``window_stats_kernel`` takes a batch of [n_cap, s_cap]
    windows: positive multiples of 32 (whole bit-packed words), with every
    pair's count of differing sites below the 16-bit sentinel."""
    return (n_cap > 0 and s_cap > 0 and n_cap % 32 == 0 and s_cap % 32 == 0
            and s_cap <= MAX_SITES)


def _pad(rows: int) -> int:
    return -(-rows // _GROUP) * _GROUP


def out_layout(r: int, pq: int, q: int) -> dict:
    """Column offset of each output in the kernel's [W, n_out] buffer."""
    lay = {"quad": 0, "n": r, "num_groups": 2 * r, "pairs_used2": 3 * r}
    off = 3 * r + pq
    for key in _Q_KEYS:
        lay[key] = off
        off += q
    lay["s"] = off
    lay["seed_risk"] = off + 1
    lay["n_out"] = off + 2
    return lay


def _dot_triples(r: int, pq: int, q: int, ia: tuple, ib: tuple) -> tuple:
    """(Y row, X row, output column) for every row-dot output.

    X / Y rows: [0, R) group weights, [R, R+Q) mask_a, [R+Q, R+2Q) mask_b,
    zero pad to rd; then rd + [0, PQ) seeds, mask_a, mask_b, pad to rp."""
    rd = _pad(r + 2 * q)
    lay = out_layout(r, pq, q)
    ya, yb = r, r + q                    # div-side mask_a / mask_b rows
    pa, pb = rd + pq, rd + pq + q        # mask-side mask_a / mask_b rows
    t = [(i, i, lay["quad"] + i) for i in range(r)]
    t += [(rd + i, rd + i, lay["pairs_used2"] + i) for i in range(pq)]
    for k in range(q):
        t += [(ya + k, ya + k, lay["sum_aa"] + k),
              (pa + k, pa + k, lay["cnt_aa"] + k),
              (yb + k, yb + k, lay["sum_bb"] + k),
              (pb + k, pb + k, lay["cnt_bb"] + k),
              (ya + k, yb + k, lay["sum_ab"] + k),
              (pa + k, pb + k, lay["cnt_ab"] + k),
              (ia[k], ib[k], lay["gdxy"] + k)]
    return tuple(t)


@functools.lru_cache(maxsize=64)
def _dots_on(dev: torch.device, r: int, pq: int, q: int, ia: tuple,
             ib: tuple) -> torch.Tensor:
    """The dot triples as an int32 [T, 3] tensor on ``dev``, copied once per
    configuration (a host-to-device copy per batch would wait for the
    previous batch's kernels)."""
    triples = _dot_triples(r, pq, q, ia, ib)
    return torch.tensor(triples, dtype=torch.int32).reshape(-1, 3).to(dev)


def window_stats_plain(geno, member, site_mask, pmasks_stack, mask_a,
                       mask_b, threshold, length, pair_a, pair_b,
                       pairs_disjoint: bool) -> dict:
    """The composition the kernel must equal (any device; it reaches no
    kernel, its grouping included)."""
    r_count = pmasks_stack.shape[-2]
    q = mask_a.shape[-2]
    pq = r_count - (0 if pairs_disjoint else 2 * q)
    ia, ib = gdxy_rows(pair_a, pair_b, pq, pairs_disjoint)
    sim, present = pairwise_identity_plain(geno, member, site_mask, length)
    gid = seed_gid_plain(sim, present, member, pmasks_stack, threshold)[1]
    out = panel_sums(sim, present, member, pmasks_stack, mask_a, mask_b,
                     threshold, ia, ib, pq, gid=gid)
    out["s"] = segregating_sites(geno, member, site_mask).to(torch.float32)
    return out


def _window_stats_cuda(geno, member, site_mask, pmasks_stack, mask_a,
                       mask_b, threshold, length, pair_a, pair_b,
                       pairs_disjoint):
    from impop_tpu_torch.ops._build import check, load_library, u8_mask

    dev = geno.device
    lead = tuple(geno.shape[:-2])
    n_cap, s_cap = geno.shape[-2:]
    r_count = pmasks_stack.shape[-2]
    q = mask_a.shape[-2]
    pq = r_count - (0 if pairs_disjoint else 2 * q)
    if geno.dtype != torch.int8:
        raise ValueError(f"window_stats: geno must be int8, got {geno.dtype}")
    if not window_kernel_fits(n_cap, s_cap):
        raise ValueError(f"window_stats: caps N={n_cap}, S={s_cap} must be "
                         f"positive multiples of 32 with S <= {MAX_SITES}")
    if len(pair_a) != q or len(pair_b) != q or pq < 0:
        raise ValueError("window_stats: pair tuples, mask stacks and "
                         "pairs_disjoint disagree")
    if not isinstance(length, torch.Tensor):
        length = torch.full(lead, float(length), device=dev)
    for name, t in (("member", member), ("site_mask", site_mask),
                    ("pmasks_stack", pmasks_stack), ("mask_a", mask_a),
                    ("mask_b", mask_b), ("length", length)):
        if t.device != dev:
            raise ValueError(f"window_stats: {name} on {t.device}, geno on "
                             f"{dev}")
    w = math.prod(lead)
    mem = u8_mask(member, "window_stats", "member", lead + (n_cap,))
    smk = u8_mask(site_mask, "window_stats", "site_mask", lead + (s_cap,))
    pmk = u8_mask(pmasks_stack, "window_stats", "pmasks_stack",
                  lead + (r_count, n_cap))
    mak = u8_mask(mask_a, "window_stats", "mask_a", lead + (q, n_cap))
    mbk = u8_mask(mask_b, "window_stats", "mask_b", lead + (q, n_cap))
    lens = length.to(torch.float32).expand(lead).contiguous()
    genc = geno.contiguous()

    lay = out_layout(r_count, pq, q)
    ia, ib = gdxy_rows(pair_a, pair_b, pq, pairs_disjoint)
    dots = _dots_on(dev, r_count, pq, q, tuple(ia), tuple(ib))
    rd, rp = _pad(r_count + 2 * q), _pad(pq + 2 * q)
    out = torch.empty((w, lay["n_out"]), dtype=torch.float32, device=dev)
    if w > 0:
        nw, sw = n_cap // 32, s_cap // 32
        t = dots.shape[0]
        bits = torch.empty((w, 2, sw, n_cap), dtype=torch.int32, device=dev)
        colbits = torch.zeros((w, 2, sw), dtype=torch.int32, device=dev)
        pres = torch.empty((w, n_cap, nw), dtype=torch.int32, device=dev)
        link = torch.empty_like(pres)
        diff = torch.empty((w, n_cap, n_cap), dtype=torch.int16, device=dev)
        x = torch.empty((w, rd + rp, n_cap), dtype=torch.float32, device=dev)
        xbits = torch.empty((w, rp, nw), dtype=torch.int32, device=dev)
        partial = torch.empty((w, t, -(-n_cap // _COL_TILE)),
                              dtype=torch.float32, device=dev)
        lib = load_library()
        with on_device(dev):   # the launch goes to the current device
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.impop_window_stats(
                genc.data_ptr(), mem.data_ptr(), smk.data_ptr(),
                pmk.data_ptr(), mak.data_ptr(), mbk.data_ptr(),
                lens.data_ptr(), dots.data_ptr(), float(threshold), w, n_cap,
                s_cap, r_count, pq, q, t, rd, rp, lay["n_out"],
                bits.data_ptr(), colbits.data_ptr(), pres.data_ptr(),
                link.data_ptr(), diff.data_ptr(), x.data_ptr(),
                xbits.data_ptr(), partial.data_ptr(), out.data_ptr(), stream)
        check(lib, err, "window_stats_kernel")
        window_stats.launches += 1
    sizes = {"quad": r_count, "n": r_count, "num_groups": r_count,
             "pairs_used2": pq, **{k: q for k in _Q_KEYS}}
    res = {k: out[:, lay[k]:lay[k] + m].reshape(lead + (m,))
           for k, m in sizes.items()}
    res["s"] = out[:, lay["s"]].reshape(lead)
    res["seed_risk"] = out[:, lay["seed_risk"]].reshape(lead)
    return res


def window_stats(geno: torch.Tensor, member: torch.Tensor,
                 site_mask: torch.Tensor, pmasks_stack: torch.Tensor,
                 mask_a: torch.Tensor, mask_b: torch.Tensor, threshold,
                 length, pair_a, pair_b, pairs_disjoint: bool) -> dict:
    """Every panel/pair statistic of a batch of biallelic windows.

    Args:
      geno:          [..., N, S] int8 (1 alt, 0 ref, -1 missing)
      member:        [..., N] bool;  site_mask: [..., S] bool
      pmasks_stack:  [..., R, N] bool grouping stack (panel_mask_stack)
      mask_a/mask_b: [..., Q, N] bool overlap-stripped Hudson sides
      threshold:     float (strict > link rule, compared in f32)
      length:        [...] window length in bp
      pair_a/pair_b: host tuples of panel indices
      pairs_disjoint: where the grouped-Hudson weight rows come from
    """
    if geno.device.type == "cpu":
        return window_stats_plain(geno, member, site_mask, pmasks_stack,
                                  mask_a, mask_b, threshold, length, pair_a,
                                  pair_b, pairs_disjoint)
    if geno.device.type == "cuda":
        return _window_stats_cuda(geno, member, site_mask, pmasks_stack,
                                  mask_a, mask_b, threshold, length, pair_a,
                                  pair_b, pairs_disjoint)
    raise ValueError(f"window_stats: unsupported device {geno.device}")


window_stats.launches = 0
