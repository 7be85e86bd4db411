"""impop_tpu_torch.stats.allele against impop_tpu.stats.allele (JAX on the
CPU backend): identity, presence, S and the allele-frequency spectra from
the same numpy tiles.

Identity counts are exact integers in float32 on both sides and
``1 - diff / length`` is the same IEEE float32 expression, so sim, present
and S must be equal, not merely close; spectra are integer histograms and
equal too."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from impop_tpu.stats.allele import allele_frequency_spectrum as j_afs
from impop_tpu.stats.allele import identity_from_alleles as j_identity
from impop_tpu.stats.allele import panel_afs as j_panel_afs
from impop_tpu.stats.allele import segregating_sites as j_sites
from impop_tpu_torch.stats.allele import (allele_frequency_spectrum,
                                          identity_from_alleles, panel_afs,
                                          segregating_sites)

torch.set_num_threads(1)


def tile(seed, n, s, frac_missing, n_pad=5, s_pad=3):
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, 6, size=n)
    base = rng.integers(0, 2, size=(6, s)).astype(np.int8)
    geno = base[cls]
    geno = np.where(rng.random((n, s)) < 0.02, 1 - geno, geno).astype(np.int8)
    geno[rng.random((n, s)) < frac_missing] = -1
    member = np.ones(n, bool)
    member[n - n_pad:] = False
    geno[n - n_pad:] = -1
    member[3] = True
    geno[3] = -1          # a member with no valid call at all
    smask = np.ones(s, bool)
    smask[s - s_pad:] = False
    return geno, member, smask


@pytest.mark.parametrize("n,s,frac_missing,length", [
    (64, 128, 0.0, 5000.0),
    (128, 128, 0.05, 5000.0),
    (128, 256, 0.3, 1000.0),
    (64, 128, 0.05, 0.0),      # padding windows carry length 0
])
def test_identity_matches_jax(n, s, frac_missing, length):
    geno, member, smask = tile(n + s, n, s, frac_missing)
    sim_j, pres_j = j_identity(jnp.asarray(geno), jnp.asarray(member),
                               jnp.asarray(smask), jnp.float32(length))
    sim_t, pres_t = identity_from_alleles(
        torch.from_numpy(geno), torch.from_numpy(member),
        torch.from_numpy(smask), torch.tensor(length))
    np.testing.assert_array_equal(pres_t.numpy(), np.asarray(pres_j))
    np.testing.assert_array_equal(sim_t.numpy(), np.asarray(sim_j))


def test_identity_batched_equals_per_window():
    tiles = [tile(k, 64, 128, 0.1) for k in range(3)]
    geno = torch.from_numpy(np.stack([t[0] for t in tiles]))
    member = torch.from_numpy(np.stack([t[1] for t in tiles]))
    smask = torch.from_numpy(np.stack([t[2] for t in tiles]))
    length = torch.tensor([5000.0, 2000.0, 1.0])
    sim, pres = identity_from_alleles(geno, member, smask, length)
    for k in range(3):
        s1, p1 = identity_from_alleles(geno[k], member[k], smask[k],
                                       length[k])
        assert torch.equal(sim[k], s1) and torch.equal(pres[k], p1)


@pytest.mark.parametrize("frac_missing", [0.0, 0.2, 0.9])
def test_segregating_sites_matches_jax(frac_missing):
    geno, member, smask = tile(7, 128, 128, frac_missing)
    want = int(j_sites(jnp.asarray(geno), jnp.asarray(member),
                       jnp.asarray(smask)))
    got = int(segregating_sites(torch.from_numpy(geno),
                                torch.from_numpy(member),
                                torch.from_numpy(smask)))
    assert got == want


@pytest.mark.parametrize("folded,max_n", [(True, 512), (False, 512),
                                          (True, 20), (False, 40)])
def test_allele_frequency_spectrum_matches_jax(folded, max_n):
    """Folded and unfolded, with counts past ``max_n`` clipped into the
    last bin."""
    geno, member, smask = tile(13, 128, 256, 0.1)
    want = np.asarray(j_afs(jnp.asarray(geno), jnp.asarray(member),
                            jnp.asarray(smask), max_n, folded))
    got = allele_frequency_spectrum(torch.from_numpy(geno),
                                    torch.from_numpy(member),
                                    torch.from_numpy(smask), max_n, folded)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("folded", [True, False])
def test_panel_afs_matches_jax(folded):
    """Per-panel spectra of a batch of windows, overlapping panels."""
    rng = np.random.default_rng(5)
    tiles = [tile(20 + k, 64, 128, 0.05) for k in range(3)]
    panels = rng.random((3, 4, 64)) < 0.4
    got = panel_afs(*(torch.from_numpy(np.stack([t[i] for t in tiles]))
                      for i in range(3)), torch.from_numpy(panels), 64,
                    folded).numpy()
    for k, (geno, member, smask) in enumerate(tiles):
        want = np.asarray(j_panel_afs(
            jnp.asarray(geno), jnp.asarray(member), jnp.asarray(smask),
            jnp.asarray(panels[k]), 64, folded))
        np.testing.assert_array_equal(got[k], want)
