"""impop_tpu_torch — the window statistics of impop in PyTorch, with CUDA
kernels for Hopper.

A port of :mod:`impop_tpu` (JAX/XLA/Pallas), which stays beside it as the
reference.  Module names mirror the JAX package so each counterpart is easy
to find:

- impop_tpu_torch.device   : explicit device resolution (no silent CPU
                             fallback when CUDA is asked for)
- impop_tpu_torch.stats    : identity, grouping, π, diversity, Fst,
                             Tajima's D and the fused per-window panel
                             statistics
- impop_tpu_torch.ops      : hand-written CUDA kernels (csrc/*.cu), each
                             beside its plain PyTorch version
- impop_tpu_torch.scanstep : the scan's wire decode + per-batch device step
- impop_tpu_torch.parallel : batched per-statistic estimators and the
                             multi-device layer (device mesh, window,
                             site and pair-space splits, multi-host)
- impop_tpu_torch.runtime  : result journal, stage timers, site streaming
                             and the similarity-window batcher
- impop_tpu_torch.cli      : ``scan``, ``tajd`` and the per-statistic
                             commands (``pi``, ``hfst``, ``hud``,
                             ``fst3pi``, ``afs``, ``panels-*``)

- impop_tpu_torch.io, .extract, .report, .hostio : the host layer (BED,
                             panels, similarity TSVs, native extraction
                             from ``cpp/``, output tables, the scan's wire
                             buffer), copies of the JAX package's JAX-free
                             modules, so both packages share one wire
                             format, one row order and one table schema

Nothing here imports ``jax`` or ``impop_tpu``
(``tests/test_torch_imports.py``).
"""

__version__ = "0.1.0"
