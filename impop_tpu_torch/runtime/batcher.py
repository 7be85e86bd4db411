"""Host-side window batching: ragged similarity windows into one padded
batch of torch tensors (port of ``impop_tpu/runtime/batcher.py``).

``PanelSet`` is a copy, not an import: the JAX module imports
``jax.numpy``.  Each window keeps its own haplotype roster in sorted-name
row order (the deterministic grouping order), padded to one capacity, with
[W, P, N] panel masks by prefix expansion (h-fst.py:64-82) or exact names.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from impop_tpu.io.panels import expand_population
from impop_tpu_torch.parallel.scan import WindowBatch

__all__ = ["PanelSet", "build_window_batch", "pad_batch_count"]


@dataclasses.dataclass(frozen=True)
class PanelSet:
    """Named population panels (raw assembly identifiers, pre-expansion)."""

    names: Tuple[str, ...]
    members: Tuple[Tuple[str, ...], ...]

    @classmethod
    def from_dict(cls, panels: Dict[str, Sequence[str]]) -> "PanelSet":
        names = tuple(panels.keys())
        return cls(names, tuple(tuple(panels[k]) for k in names))

    @property
    def count(self) -> int:
        return len(self.names)

    def index(self, name: str) -> int:
        return self.names.index(name)


def pad_batch_count(w: int, multiple: int) -> int:
    return ((w + multiple - 1) // multiple) * multiple


def build_window_batch(mats: Sequence, panels: Optional[PanelSet],
                       capacity: int, batch_pad: int = 1,
                       exact_names: bool = False, *,
                       device: str | torch.device = "cpu"
                       ) -> Tuple[WindowBatch, List[List[str]]]:
    """Stack per-window ``SimilarityMatrix`` objects into a WindowBatch on
    ``device``.

    Args:
      mats: one parsed (already rounded) similarity matrix per window
      panels: population panels; None gives one all-members panel
      capacity: N; a larger window raises
      batch_pad: pad the window count up to a multiple (padding windows
        have no members)
      exact_names: the panels list sequence names rather than assembly
        identifiers to expand by prefix

    Returns (batch, the row names of each window).
    """
    w_real = len(mats)
    w = pad_batch_count(max(w_real, 1), batch_pad)
    p = panels.count if panels is not None else 1
    sim = np.zeros((w, capacity, capacity), dtype=np.float32)
    present = np.zeros((w, capacity, capacity), dtype=bool)
    member = np.zeros((w, capacity), dtype=bool)
    panel_masks = np.zeros((w, p, capacity), dtype=bool)
    names_per_window: List[List[str]] = []
    for wi, mat in enumerate(mats):
        n = mat.n
        if n > capacity:
            raise ValueError(f"window {wi} has {n} haplotypes > capacity "
                             f"{capacity}")
        sim[wi, :n, :n] = mat.sim
        present[wi, :n, :n] = mat.present
        member[wi, :n] = True
        names_per_window.append(list(mat.names))
        idx = mat.index()
        if panels is None:
            panel_masks[wi, 0, :n] = True
            continue
        for pi, plist in enumerate(panels.members):
            if exact_names:
                matched = [s for s in plist if s in idx]
            else:
                matched, _ = expand_population(plist, mat.names)
            for s in matched:
                panel_masks[wi, pi, idx[s]] = True
    batch = WindowBatch(*(torch.from_numpy(a).to(device)
                          for a in (sim, present, member, panel_masks)))
    return batch, names_per_window
