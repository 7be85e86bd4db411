"""Identity from allele tiles for a batch of windows (port of
``impop_tpu.ops.pairdiff``: ``pairwise_identity_pallas`` in both its
unit-weight schedules, ``_pairwise_identity_pallas_i8``, and the weighted
branch).

Unit weights, with v = valid (call >= 0, member row, active site) and
z = 2·max(g, 0) − v on valid cells (0 elsewhere):

    compared = v·vᵀ,  diff = (v·vᵀ − z·zᵀ) / 2

Column-mode weights:

    diff = Σ_s w_s (a_i c_j + c_i a_j),  compared = Σ_s v_i v_j

and in both

    present = compared > 0 ∧ member_i ∧ member_j
    sim = 1 − diff / max(length, 1) where present, the member diagonal 1

- :func:`pairwise_identity_plain` / :func:`pairwise_identity_weighted_plain`:
  float32 ``torch.matmul`` Grams (TF32 off on CUDA), then the reference's
  epilogue.
- :func:`pairwise_identity` / :func:`pairwise_identity_weighted`: the
  wrappers.  CPU tensors take the plain version; CUDA tensors launch the
  kernels of ``csrc/pairdiff.cu`` (tensor-core Grams over i <= j
  128 x 128 tile pairs, mirrored: int8 ``wgmma`` in ``unit_gram_kernel``
  for unit weights, bf16 ``mma.sync`` on an exact three-piece split of the
  weights in ``weighted_gram_kernel`` for columns mode), every N and S, or
  raise.

What the kernels' wrappers compute in Python, and the CPU tests check:
:func:`identity_partition` (tile pairs and the site split that fills the
card), :func:`tile_pair` (the kernel's pair order), :func:`split_weights`
(the exact bf16 pieces) and :func:`pairwise_identity_weighted_split_plain`
(the split Gram emulated in float32).

The unit-weight z-Gram is the polynomial ``x(v−x)ᵀ + (v−x)xᵀ`` of the
reference's CPU path for any code x, so codes above 1 agree too.  Counts
are exact integers below 2^24 on every path, so sim and present are equal,
not close; so are weighted sums with integer weights (indel lengths).
"""
from __future__ import annotations

import functools
import math

import torch

from impop_tpu_torch.device import on_device
from impop_tpu_torch.stats.allele import (_valid, identity_epilogue,
                                          pairwise_diff_biallelic)

__all__ = ["pairwise_identity", "pairwise_identity_plain",
           "pairwise_identity_weighted", "pairwise_identity_weighted_plain",
           "pairwise_identity_weighted_split_plain", "identity_partition",
           "split_weights", "tile_pair"]


def pairwise_identity_plain(geno, member, site_mask, length
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(sim [..., N, N] f32, present [..., N, N] bool), any device."""
    valid = _valid(geno, member, site_mask)
    v = valid.to(torch.float32)
    z = torch.where(valid, 2.0 * geno.clamp(min=0).to(torch.float32) - 1.0,
                    0.0)
    vv = v @ v.transpose(-1, -2)
    zz = z @ z.transpose(-1, -2)
    return identity_epilogue((vv - zz) * 0.5, vv, member, length)


TILE = 128            # output tile edge of gram_kernel
KT_UNIT = 64          # sites per pipeline stage, unit weights
KT_WEIGHTED = 32      # sites per pipeline stage, column weights
MAX_SPLITS = 8
SPLIT_COST = 0.15     # per extra split: scratch traffic and the reduce
#                       (fitted to a sweep of forced splits on an H100)


def tile_pair(p: int, t: int) -> tuple[int, int]:
    """Linear tile-pair index -> (ti, tj), row-major over ti <= tj: the
    order of ``tile_pair`` in ``csrc/pairdiff.cu``."""
    ti = 0
    while p >= t - ti:
        p -= t - ti
        ti += 1
    return ti, ti + p


def identity_partition(w: int, n: int, s: int, kt: int, sm_count: int,
                       splits: int | None = None) -> tuple[int, int, int, int]:
    """(tile blocks per edge, tile pairs, splits, stages per split) of one
    launch over ``w`` windows of [n, s].

    A block computes one (window, tile pair ti <= tj) over ``chunk`` stages
    of ``kt`` sites.  With fewer blocks than the card has SMs (one block
    fits an SM), the sites are split so that the waves of blocks fill the
    card: the split count minimises waves / splits · (1 + SPLIT_COST ·
    (splits − 1)) (the partial Grams go through a scratch and a reduce
    kernel), each split holding at least two stages.  ``splits`` overrides the choice."""
    t = -(-n // TILE)
    pairs = t * (t + 1) // 2
    nk = -(-s // kt)
    if splits is None:
        blocks = max(w * pairs, 1)
        best, splits = -(-blocks // sm_count), 1
        for ks in range(2, min(MAX_SPLITS, nk // 2) + 1):
            cost = (-(-blocks * ks // sm_count) / ks
                    * (1.0 + SPLIT_COST * (ks - 1)))
            if cost < best:
                best, splits = cost, ks
    splits = max(1, min(splits, nk))
    chunk = -(-nk // splits) if nk else 1
    splits = -(-nk // chunk) if nk else 1
    return t, pairs, splits, chunk


def split_weights(w: torch.Tensor) -> torch.Tensor:
    """[3, ...] float32 pieces of the float32 weights ``w``, each exactly a
    bf16 value, summing back to ``w`` bit for bit: each piece is the top 8
    significant bits of what is left, rounded toward zero (the high half of
    the float32 word), as ``decode_weighted`` in ``csrc/pairdiff.cu``."""
    def hi(x):
        return (x.view(torch.int32) & -65536).view(torch.float32)

    w = w.to(torch.float32).contiguous()
    w1 = hi(w)
    r1 = w - w1
    w2 = hi(r1)
    w3 = hi(r1 - w2)
    return torch.stack([w1, w2, w3])


def pairwise_identity_weighted_split_plain(geno, member, site_mask, length,
                                           site_weights
                                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The weighted kernel's arithmetic in float32, any device: row operand
    [a·w_p | c·w_p] for the three pieces w_p of :func:`split_weights`,
    column operand [c | a] (biallelic: a code above 1 counts as alt),
    compared = v·vᵀ, then the reference's epilogue."""
    valid = _valid(geno, member, site_mask)
    v = valid.to(torch.float32)
    a = (valid & (geno > 0)).to(torch.float32)
    c = v - a
    pieces = split_weights(site_weights)[..., None, :]
    col = torch.cat([c, a], dim=-1)
    diff = torch.zeros(v.shape[:-1] + v.shape[-2:-1], dtype=torch.float32,
                       device=geno.device)
    for wp in pieces:
        diff = diff + torch.cat([a * wp, c * wp], dim=-1) @ col.transpose(-1, -2)
    return identity_epilogue(diff, v @ v.transpose(-1, -2), member, length)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, with a 16-byte aligned first element (16-byte copies)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _window_args(what, geno, member, site_mask, length, extra=()):
    """Checked kernel arguments: (lead, n, s, w, geno, member u8,
    site_mask u8, length f32 [W]), contiguous and 16-byte aligned, with S
    padded to a multiple of 16 (masked columns) when it is not one."""
    from impop_tpu_torch.ops._build import u8_mask

    dev = geno.device
    lead = tuple(geno.shape[:-2])
    n, s = geno.shape[-2:]
    if geno.dtype != torch.int8:
        raise ValueError(f"{what}: geno must be int8, got {geno.dtype}")
    w = math.prod(lead)
    if w > 65535:
        raise ValueError(f"{what}: {w} windows exceed the grid's 65535")
    if not isinstance(length, torch.Tensor):
        length = torch.full(lead, float(length), device=dev)
    for name, t in (("member", member), ("site_mask", site_mask),
                    ("length", length)) + tuple(extra):
        if t.device != dev:
            raise ValueError(f"{what}: {name} on {t.device}, geno on {dev}")
    mem = u8_mask(member, what, "member", lead + (n,))
    smk = u8_mask(site_mask, what, "site_mask", lead + (s,))
    if site_mask.dtype != torch.bool:
        smk = smk.ne(0).view(torch.uint8)     # the decode wants 0 / 1
    lens = length.to(torch.float32).expand(lead).contiguous()
    pad = -s % 16
    if pad:
        geno = torch.nn.functional.pad(geno, (0, pad))
        smk = torch.nn.functional.pad(smk, (0, pad))
    return (lead, n, s + pad, w, _aligned(geno), mem.contiguous(),
            _aligned(smk), lens)


def _launch(entry, kernel, geno, member, site_mask, length, weights=None,
            splits=None):
    from impop_tpu_torch.ops._build import check, load_library

    what = ("pairwise_identity" if weights is None
            else "pairwise_identity_weighted")
    extra = () if weights is None else (("site_weights", weights),)
    lead, n, s, w, genc, mem, smk, lens = _window_args(
        what, geno, member, site_mask, length, extra)
    dev = geno.device
    wts = ()
    if weights is not None:
        wts = weights.to(torch.float32).expand(lead + (weights.shape[-1],))
        if wts.shape[-1] != s:
            wts = torch.nn.functional.pad(wts, (0, s - wts.shape[-1]))
        wts = (_aligned(wts),)
    sim = torch.empty(lead + (n, n), dtype=torch.float32, device=dev)
    pres = torch.empty(lead + (n, n), dtype=torch.uint8, device=dev)
    if w > 0 and n > 0:
        kt = KT_UNIT if weights is None else KT_WEIGHTED
        # a tensor's CUDA device always carries its index
        _, pairs, ks, chunk = identity_partition(w, n, s, kt,
                                                 _sm_count(dev.index), splits)
        scratch = (torch.empty(ks * w * pairs * 128 * 256, dtype=torch.int32,
                               device=dev) if ks > 1 else None)
        lib = load_library()
        ptrs = [t.data_ptr() for t in (genc, mem, smk) + wts + (lens,)]
        with on_device(dev):   # the launch goes to the current device
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = getattr(lib, entry)(
                *ptrs, w, n, s, ks, chunk,
                scratch.data_ptr() if scratch is not None else None,
                sim.data_ptr(), pres.data_ptr(), stream)
        check(lib, err, kernel)
    return sim, pres.view(torch.bool)


def _pairwise_identity_cuda(geno, member, site_mask, length, splits=None):
    out = _launch("impop_pairwise_identity", "unit_gram_kernel", geno,
                  member, site_mask, length, splits=splits)
    pairwise_identity.launches += 1
    return out


def pairwise_identity(geno: torch.Tensor, member: torch.Tensor,
                      site_mask: torch.Tensor, length
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Unit-weight identity of a batch of windows.

    Args:
      geno:      [..., N, S] int8 (allele codes, -1 missing); the kernel is
                 exact for codes up to 63 (z = 2g − 1 must fit int8)
      member:    [..., N] bool;  site_mask: [..., S] bool
      length:    [...] window length in bp (or a scalar)
    Returns (sim [..., N, N] f32, present [..., N, N] bool).
    """
    if geno.device.type == "cpu":
        return pairwise_identity_plain(geno, member, site_mask, length)
    if geno.device.type == "cuda":
        return _pairwise_identity_cuda(geno, member, site_mask, length)
    raise ValueError(f"pairwise_identity: unsupported device {geno.device}")


pairwise_identity.launches = 0


def pairwise_identity_weighted_plain(geno, member, site_mask, length,
                                     site_weights
                                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(sim [..., N, N] f32, present [..., N, N] bool), any device."""
    diff, compared = pairwise_diff_biallelic(geno, member, site_mask,
                                             site_weights)
    return identity_epilogue(diff, compared, member, length)


def _weighted_identity_cuda(geno, member, site_mask, length, site_weights,
                            splits=None):
    out = _launch("impop_weighted_identity", "weighted_gram_kernel", geno,
                  member, site_mask, length, site_weights, splits)
    pairwise_identity_weighted.launches += 1
    return out


def pairwise_identity_weighted(geno: torch.Tensor, member: torch.Tensor,
                               site_mask: torch.Tensor, length,
                               site_weights: torch.Tensor
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Column-mode identity of a batch of biallelic windows.

    Args:
      geno:         [..., N, S] int8 (1 alt, 0 ref, -1 missing)
      member:       [..., N] bool;  site_mask: [..., S] bool
      length:       [...] window length in bp (or a scalar)
      site_weights: [..., S] f32 per-site diff weights; integer weights
                    with per-pair sums below 2^24 are exact on every path,
                    other weights agree within float32 rounding of the sums
    Returns (sim [..., N, N] f32, present [..., N, N] bool).
    """
    if geno.device.type == "cpu":
        return pairwise_identity_weighted_plain(geno, member, site_mask,
                                                length, site_weights)
    if geno.device.type == "cuda":
        return _weighted_identity_cuda(geno, member, site_mask, length,
                                       site_weights)
    raise ValueError("pairwise_identity_weighted: unsupported device "
                     f"{geno.device}")


pairwise_identity_weighted.launches = 0
