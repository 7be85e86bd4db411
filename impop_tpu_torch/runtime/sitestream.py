"""Host-streamed site chunks: one window of any length (port of
:mod:`impop_tpu.runtime.sitestream`).

The site axis of a window goes through the device in fixed-width chunks,
and the running state stays on the device: pairwise difference and
comparison counts [N, N], the segregating-site count and the allele
frequency spectrum.  Device memory is O(N·chunk + N²) whatever the
window's length, so a window can be a whole chromosome.

Every accumulated quantity is an exact integer sum over disjoint chunks:
diff / compared (per-chunk ``stats.allele.pairwise_diff``, plain float32
``torch.matmul`` as the JAX package leaves it to XLA), S (each polymorphic
column lies in one chunk) and the AFS (one increment per column).  Unit
weights accumulate in int32, exact past the float32 2^24 ceiling; weighted
counts in float32, exact while Σ weights < 2^24 per pair.  Unlike the JAX
package's donated buffers, the state tensors are updated in place.

    acc = SiteStreamAccumulator(member, afs_max_n=n, device=dev)
    for chunk in chunks:               # [N, Sc] int8, -1 = missing
        acc.update(chunk)
    stats = acc.finalize(length, threshold)
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from impop_tpu_torch.device import resolve_device
from impop_tpu_torch.stats.allele import (allele_frequency_spectrum,
                                          pairwise_diff, segregating_sites)
from impop_tpu_torch.stats.pi import pi_grouped
from impop_tpu_torch.stats.tajima import tajimas_d

__all__ = ["SiteStreamAccumulator", "StreamedWindowStats"]


class StreamedWindowStats(NamedTuple):
    pi: torch.Tensor        # pica2-grouped π (absolute, not per site)
    pi_site: torch.Tensor   # π / length
    s: torch.Tensor         # segregating sites (int32)
    d: torch.Tensor         # Tajima's D
    n: torch.Tensor         # member count
    sim: torch.Tensor       # [N, N] identity matrix
    present: torch.Tensor   # [N, N] pair-has-data mask
    afs: torch.Tensor       # [afs_max_n + 1] int32 histogram


class SiteStreamAccumulator:
    """Streaming accumulator for one window's site axis.

    Args:
      member: [N] bool (numpy or torch), fixed across chunks.
      chunk_s: chunk width; each incoming chunk is padded (allele -1,
        masked) to a multiple of it, so every update runs the same shapes.
      num_alleles: allele-code alphabet size (2 = biallelic).
      afs_max_n: spectrum size (0 disables the spectrum).
      folded: minor-allele (True) or derived-allele (False) spectrum.
      weighted: updates carry per-site weights (column-mode identity).
      device: where the state lives and every chunk is computed (the
        card unless the caller asks for ``"cpu"``; raises without CUDA).
    """

    def __init__(self, member, chunk_s: int = 4096, num_alleles: int = 2,
                 afs_max_n: int = 0, folded: bool = True,
                 weighted: bool = False, device="cuda"):
        self.device = resolve_device(device)
        self._member = torch.as_tensor(np.asarray(member, bool)).to(
            self.device)
        self.n_cap = self._member.shape[0]
        self.chunk_s = int(chunk_s)
        self.num_alleles = int(num_alleles)
        self.afs_max_n = int(afs_max_n)
        self.folded = bool(folded)
        self.weighted = bool(weighted)
        acc_dtype = torch.float32 if self.weighted else torch.int32

        def zeros(*shape, dtype=acc_dtype):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        self._diff = zeros(self.n_cap, self.n_cap)
        self._comp = zeros(self.n_cap, self.n_cap)
        self._s = zeros(dtype=torch.int32)
        self._afs = zeros(max(self.afs_max_n, 0) + 1, dtype=torch.int32)
        self._finalized = False

    def update(self, geno_chunk: np.ndarray,
               site_weights: Optional[np.ndarray] = None) -> None:
        """Fold one [N, Sc] int8 site chunk into the state, in place."""
        if self._finalized:
            raise RuntimeError("accumulator already finalized")
        if site_weights is not None and not self.weighted:
            raise ValueError(
                "site_weights passed to an unweighted accumulator; "
                "construct with weighted=True")
        g = np.asarray(geno_chunk, np.int8)
        if g.ndim != 2 or g.shape[0] != self.n_cap:
            raise ValueError(
                f"chunk must be [{self.n_cap}, Sc]; got {g.shape}")
        s = g.shape[1]
        cap = max(self.chunk_s, -(-s // self.chunk_s) * self.chunk_s)
        pad = np.full((self.n_cap, cap), -1, np.int8)
        pad[:, :s] = g
        smask = np.zeros(cap, bool)
        smask[:s] = True
        dev = self.device
        geno = torch.from_numpy(pad).to(dev)
        smask_t = torch.from_numpy(smask).to(dev)
        w = None
        if site_weights is not None:
            wn = np.zeros(cap, np.float32)
            wn[:s] = np.asarray(site_weights, np.float32)
            w = torch.from_numpy(wn).to(dev)
        d_c, c_c = pairwise_diff(geno, self._member, smask_t,
                                 self.num_alleles, w)
        # per-chunk sums are exact in float32 (at most chunk_s · w_max)
        self._diff += d_c.to(self._diff.dtype)
        self._comp += c_c.to(self._comp.dtype)
        self._s += segregating_sites(geno, self._member, smask_t)
        if self.afs_max_n > 0:
            self._afs += allele_frequency_spectrum(
                geno, self._member, smask_t, self.afs_max_n, self.folded)

    def finalize(self, length: float, threshold: float,
                 pi_member=None) -> StreamedWindowStats:
        """Identity matrix, grouped π, S, Tajima's D and the spectrum.

        ``pi_member`` ([N] bool) restricts the grouped-π membership (and so
        n and D) to a subset without narrowing S or the counts: S covers
        the whole window (run_tajd.sh:148), the subset only feeds π
        (run_tajd.sh:160)."""
        self._finalized = True
        member = self._member
        pim = member
        if pi_member is not None:
            pim = torch.as_tensor(np.asarray(pi_member, bool)).to(
                self.device) & member
        diff = self._diff.to(torch.float32)
        comp = self._comp.to(torch.float32)
        present = (comp > 0) & member[:, None] & member[None, :]
        ln = torch.tensor(max(float(length), 1.0), dtype=torch.float32,
                          device=self.device)
        sim = torch.where(present, 1.0 - diff / ln, 0.0)
        eye = torch.eye(self.n_cap, dtype=torch.bool, device=self.device)
        diag = eye & member[:, None]
        sim = torch.where(diag, 1.0, sim)
        present = present | diag
        res = pi_grouped(sim, present, pim, threshold)
        pi_site = res.pi / ln
        d = tajimas_d(res.n, self._s.to(torch.float32), pi_site)
        return StreamedWindowStats(res.pi, pi_site, self._s, d, res.n, sim,
                                   present, self._afs)
