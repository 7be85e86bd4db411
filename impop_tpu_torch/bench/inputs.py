"""Seeded inputs at the HPRC shape for the kernel measurements
(``chip_smoke.py`` and ``bench/window_breakdown.py`` time the same
batches)."""
from __future__ import annotations

__all__ = ["N_HAP", "CAP_N", "CAP_S", "WIN_BP", "BATCH", "THRESHOLD",
           "PANEL_SIZES", "hprc_batch", "long_batch", "to_dev"]

N_HAP = 466                   # HPRC v2: 465 assemblies + CHM13
CAP_N, CAP_S = 512, 128
WIN_BP = 5000
BATCH = 320
THRESHOLD = 0.999
PANEL_SIZES = {"AFR": 140, "AMR": 88, "EAS": 100, "EUR": 60, "SAS": 72}


def hprc_batch(rng, w, cap_n=CAP_N, cap_s=CAP_S, n_hap=N_HAP):
    """HPRC-shaped windows: a few haplotype classes with class-structured
    variation and 0.1% noise, the five continental panels side by side.
    Returns numpy (geno, member, site mask, panels, lengths)."""
    import numpy as np

    geno = np.full((w, cap_n, cap_s), -1, dtype=np.int8)
    member = np.zeros((w, cap_n), bool)
    smask = np.zeros((w, cap_s), bool)
    for wi in range(w):
        n_classes = int(rng.integers(3, 12))
        n_sites = int(rng.integers(20, cap_s)) if cap_s > 20 else cap_s
        classes = rng.integers(0, 2, size=(n_classes, n_sites)).astype(
            np.int8)
        g = classes[rng.integers(0, n_classes, size=n_hap)]
        g = np.where(rng.random((n_hap, n_sites)) < 0.001, 1 - g, g)
        geno[wi, :n_hap, :n_sites] = g
        member[wi, :n_hap] = True
        smask[wi, :n_sites] = True
    panels = np.zeros((w, len(PANEL_SIZES), cap_n), bool)
    start = 0
    for pi, size in enumerate(PANEL_SIZES.values()):
        panels[:, pi, start:start + size] = True
        start += size
    lengths = np.full(w, float(WIN_BP), np.float32)
    return geno, member, smask, panels, lengths


def long_batch(rng, w, cap_n=CAP_N, cap_s=2048, n_hap=N_HAP, bp=200_000.0):
    """Long windows: class-structured haplotypes over every site (about
    the density of a 200 kb window of the simulated pangenome).  Returns
    numpy (geno, member, site mask, lengths)."""
    import numpy as np

    geno = np.full((w, cap_n, cap_s), -1, dtype=np.int8)
    for wi in range(w):
        classes = rng.integers(0, 2, size=(8, cap_s)).astype(np.int8)
        g = classes[rng.integers(0, 8, size=n_hap)]
        geno[wi, :n_hap] = np.where(rng.random((n_hap, cap_s)) < 0.002,
                                    1 - g, g)
    geno[:, :n_hap][rng.random((w, n_hap, cap_s)) < 0.01] = -1
    member = np.zeros((w, cap_n), bool)
    member[:, :n_hap] = True
    smask = np.ones((w, cap_s), bool)
    smask[:, cap_s - 37:] = False
    return geno, member, smask, np.full(w, bp, np.float32)


def to_dev(dev, *arrays):
    """The numpy arrays as tensors on ``dev``."""
    import torch

    return [torch.from_numpy(a).to(dev) for a in arrays]
