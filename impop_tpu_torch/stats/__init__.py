"""Estimators of the fused scan (counterparts of :mod:`impop_tpu.stats`).

Functions take an explicit leading window axis where the JAX package used
``vmap``: shapes are ``[..., N, S]`` / ``[..., N, N]`` rather than one
window at a time."""
