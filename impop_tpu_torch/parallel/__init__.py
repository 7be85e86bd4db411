"""Batched and multi-device window statistics (counterparts of
:mod:`impop_tpu.parallel`): the window and panel axes are batch dimensions
of one device call, and a (data, site) mesh of devices splits windows,
sites or the pair space over several devices."""
from impop_tpu_torch.parallel.mesh import (Mesh, gather_windows, make_mesh,
                                           reduce_max, reduce_min,
                                           reduce_sum, split_sites,
                                           split_windows)
from impop_tpu_torch.parallel.scan import (WindowBatch, batch_allele_stats,
                                           batch_hudson, batch_over,
                                           batch_pi_panels, shard_batch)

__all__ = [
    "Mesh",
    "make_mesh",
    "split_windows",
    "split_sites",
    "gather_windows",
    "reduce_sum",
    "reduce_min",
    "reduce_max",
    "WindowBatch",
    "shard_batch",
    "batch_over",
    "batch_pi_panels",
    "batch_hudson",
    "batch_allele_stats",
]
