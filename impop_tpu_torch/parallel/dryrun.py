"""A multi-device dry run (counterpart of
``__graft_entry__.dryrun_multichip``).

On a (n/2, 2) grid of one device (repeats allowed: ``[cpu] x 8`` on a
host, ``[cuda:0] x 8`` on a one-card machine) it runs, on tiny seeded
shapes, every multi-device path of the port and holds each against its
one-device result:

1. ``batch_hudson`` over the ``data`` axis (``parallel.scan.batch_over``);
2. ``site_sharded_window_stats`` on the whole grid against a (1, 1) grid;
3. ``pair_sharded_direct_stats`` over ``data`` against
   ``stats.fst.hudson_fst_direct_pairs`` on the full identity;
4. the scan's batches dealt over ``data`` as the scan deals them (batch
   k to entry k mod D: ``scanstep.deal_wire``, ``scan_step``,
   ``rows_to_host``) against ``scan_step`` on the whole batch on one
   device.

On CUDA tensors these dispatch the real kernels (seed peel, masked sums,
unit identity, window kernel), not a plain twin.  Tolerances: integers
exact, π / Dxy / EHH rtol 1e-5, Fst and D atol 2e-3.
"""
from __future__ import annotations

import numpy as np
import torch

from impop_tpu_torch.device import resolve_device

__all__ = ["dryrun_multidevice"]

RTOL, FST_ATOL = 1e-5, 2e-3


def _close(name, got, want, exact=False, atol=0.0):
    got = got.detach().cpu().to(torch.float64).numpy()
    want = want.detach().cpu().to(torch.float64).numpy()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {got.shape} vs {want.shape}")
    ok = (np.array_equal(got, want, equal_nan=True) if exact else
          np.allclose(got, want, rtol=RTOL, atol=atol or 1e-7,
                      equal_nan=True))
    if not ok:
        raise AssertionError(f"{name}: {got} vs {want}")
    both = np.isfinite(got) & np.isfinite(want)
    return float(np.abs(got - want)[both].max(initial=0.0))


def _hudson_batch(rng, w, n, p):
    sim = rng.uniform(0.99, 1.0, size=(w, n, n)).astype(np.float32)
    sim = (sim + sim.transpose(0, 2, 1)) / 2
    present = rng.random((w, n, n)) < 0.95
    present = present & present.transpose(0, 2, 1)
    idx = np.arange(n)
    sim[:, idx, idx] = 1.0
    present[:, idx, idx] = True
    member = np.ones((w, n), bool)
    member[:, n - 3:] = False
    panels = np.zeros((w, p, n), bool)
    panels[:, 0, :n // 2] = True
    panels[:, 1, n // 2:] = True
    return sim, present, member, panels


def _geno(rng, shape, missing=0.05):
    g = rng.integers(0, 2, size=shape).astype(np.int8)
    g[rng.random(shape) < missing] = -1
    return g


def dryrun_multidevice(n_devices: int, device) -> dict:
    """Run the four paths on a (n_devices/2, 2) grid of ``device``
    (``"cuda:0"``, ``"cpu"``, ...); raise
    AssertionError on the first disagreement.  Returns the largest
    absolute difference of each path."""
    from impop_tpu_torch.hostio import pack_scan_batch
    from impop_tpu_torch.parallel.longwindow import site_sharded_window_stats
    from impop_tpu_torch.parallel.mesh import make_mesh
    from impop_tpu_torch.parallel.pairspace import pair_sharded_direct_stats
    from impop_tpu_torch.parallel.scan import (WindowBatch, batch_hudson,
                                               batch_over)
    from impop_tpu_torch.device import on_device
    from impop_tpu_torch.scanstep import deal_wire, rows_to_host, scan_step
    from impop_tpu_torch.stats.allele import (identity_from_alleles,
                                              segregating_sites)
    from impop_tpu_torch.stats.fst import hudson_fst_direct_pairs

    if n_devices < 2 or n_devices % 2:
        raise ValueError(f"dryrun_multidevice: n_devices={n_devices} must be "
                         "even and at least 2")
    dev = resolve_device(device)
    data = n_devices // 2
    mesh = make_mesh(data=data, site=2, devices=[dev] * n_devices)
    one = make_mesh(data=1, site=1, devices=[dev])
    rng = np.random.default_rng(0)
    report = {}

    # 1: window-split Hudson Fst, two windows a data shard and one more,
    # so the last shard carries a padding window
    n, p = 32, 2
    w = 2 * data + 1
    batch = WindowBatch(*(torch.from_numpy(a).to(dev)
                          for a in _hudson_batch(rng, w, n, p)))
    got = batch_over(batch_hudson, batch, mesh, (0,), (1,), 0.999)
    want = batch_hudson(*batch, (0,), (1,), 0.999)
    errs = []
    for kind in ("direct", "grouped"):
        g, r = getattr(got, kind), getattr(want, kind)
        for f in ("pi_a", "pi_b", "dxy"):
            errs.append(_close(f"batch_hudson {kind}.{f}", getattr(g, f),
                               getattr(r, f)))
        errs.append(_close(f"batch_hudson {kind}.fst", g.fst, r.fst,
                           atol=FST_ATOL))
    report["batch_hudson"] = max(errs)

    # 2: site-sharded long windows
    s = 64
    geno = _geno(rng, (w, n, s))
    member = np.ones((w, n), bool)
    member[:, n - 2:] = False
    smask = np.ones((w, s), bool)
    smask[:, s - 5:] = False
    lengths = np.full(w, 1000.0, np.float32)
    args = (geno, member, smask, lengths, 0.999)
    pi_g, s_g, d_g = site_sharded_window_stats(mesh, n)(*args)
    pi_1, s_1, d_1 = site_sharded_window_stats(one, n)(*args)
    report["site_sharded_window_stats"] = max(
        _close("long window S", s_g, s_1, exact=True),
        _close("long window pi", pi_g, pi_1),
        _close("long window D", d_g, d_1, atol=FST_ATOL))

    # 3: the pair space in row blocks over data
    n_big, q = 16 * data, 2
    g1 = _geno(rng, (n_big, s))
    mem1 = np.ones(n_big, bool)
    sm1 = np.ones(s, bool)
    masks_a = np.zeros((q, n_big), bool)
    masks_b = np.zeros((q, n_big), bool)
    for k in range(q):
        perm = rng.permutation(n_big)
        masks_a[k, perm[:n_big // 3]] = True
        masks_b[k, perm[n_big // 3:2 * n_big // 3]] = True
    got = pair_sharded_direct_stats(mesh, "data")(
        g1, mem1, sm1, masks_a, masks_b, 1000.0)
    t = [torch.from_numpy(a).to(dev) for a in (g1, mem1, sm1)]
    sim, present = identity_from_alleles(*t, 1000.0)
    ref = hudson_fst_direct_pairs(sim, present,
                                  torch.from_numpy(masks_a).to(dev),
                                  torch.from_numpy(masks_b).to(dev))
    want_s = segregating_sites(*t)
    report["pair_sharded_direct_stats"] = max(
        _close("pair shard pi_a", got[0], ref.pi_a),
        _close("pair shard pi_b", got[1], ref.pi_b),
        _close("pair shard dxy", got[2], ref.dxy),
        _close("pair shard fst", got[3], ref.fst, atol=FST_ATOL),
        _close("pair shard S", got[4], want_s, exact=True))

    # 4: the scan's batches of two windows dealt over data
    cap_n, cap_s, p3 = 64, 128, 3
    geno = np.full((w, cap_n, cap_s), -1, np.int8)
    geno[:, :40, :90] = _geno(rng, (w, 40, 90))
    member = np.zeros((w, cap_n), bool)
    member[:, :40] = True
    smask = np.zeros((w, cap_s), bool)
    smask[:, :90] = True
    panels = np.zeros((w, p3, cap_n), bool)
    for k in range(p3):
        panels[:, k, 13 * k:13 * (k + 1)] = True
    flat = pack_scan_batch(geno, member, smask, panels,
                           np.full(w, 5000, np.uint32), None, False)
    pair_key = ((0, 1), (0, 2), (1, 2))
    step_args = (cap_n, cap_s, p3, pair_key, 0.999, True)
    entries = mesh.axis_devices("data")
    fetched = []
    for k, lo in enumerate(range(0, w, 2)):
        entry = entries[k % len(entries)]
        wire = deal_wire(flat[lo:lo + 2], entry)
        with on_device(entry):
            fetched.append(rows_to_host(scan_step(wire, *step_args)))
    for _, done in fetched:
        if done is not None:
            done.synchronize()
    got = torch.cat([host for host, _ in fetched])
    want = scan_step(torch.from_numpy(flat).to(dev), *step_args)
    # every column at once: rtol 1e-5 with atol 2e-3 holds integers exact
    # (they differ by 1 or not at all) and Fst within its budget
    report["scan_deal"] = _close("scan step rows", got, want, atol=FST_ATOL)
    report["scan_deal bitwise"] = bool(torch.equal(
        got.cpu().nan_to_num(7.0), want.cpu().nan_to_num(7.0)))
    return report
