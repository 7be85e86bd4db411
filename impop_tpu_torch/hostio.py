"""The JAX-free host code both packages share, imported from
:mod:`impop_tpu` (never copied).

Sharing keeps one wire format, one row order (names are sorted before
packing, and the greedy seed order depends on it) and one table schema.
None of these modules loads ``jax``; ``tests/test_torch_imports.py``
checks that importing the port leaves ``jax`` out of ``sys.modules``.
"""
from __future__ import annotations

import os
import subprocess

from impop_tpu.cli import (DirSimSource, GenoSource, GfaDirSource,
                           ImpgSimSource, SimSource, WindowError,
                           _add_common, _add_sim_args, _capacity_for,
                           _load_windows, _open_extractor, _out_stream,
                           _panel_label, _print_counters, _resolve_fasta,
                           _scan_buf_layout, _write_window_log,
                           pack_scan_batch, split_multiallelic)
from impop_tpu.extract import library_path, site_weights_from_keys
from impop_tpu.extract.simulate import simulate
from impop_tpu.io.bed import parse_region, read_bed
from impop_tpu.io.panels import expand_population, read_panel_file
from impop_tpu.io.simtsv import (SimilarityMatrix, read_similarity_tsv,
                                 round_half_even, write_similarity_tsv)
from impop_tpu.report import tables

__all__ = ["DirSimSource", "GenoSource", "GfaDirSource", "ImpgSimSource",
           "SimSource", "WindowError", "tables", "_add_common",
           "_add_sim_args", "_capacity_for", "_load_windows",
           "_open_extractor", "open_extractor",
           "_out_stream", "_panel_label", "_print_counters", "_resolve_fasta",
           "_scan_buf_layout", "_write_window_log", "pack_scan_batch",
           "split_multiallelic", "simulate", "parse_region", "read_bed",
           "expand_population", "read_panel_file", "SimilarityMatrix",
           "read_similarity_tsv", "round_half_even", "write_similarity_tsv",
           "site_weights_from_keys"]


def open_extractor(paf: str, fasta: str):
    """``impop_tpu.cli._open_extractor``, after building the shared native
    extraction library (``cpp/``, when it is not built yet) with the
    platform compiler: ``make``'s default ``g++``, not an inherited
    ``$CXX``.  The library is loaded into CPython through ctypes and must
    link the system's shared libstdc++; a toolchain that links libstdc++
    statically into the shared object leaves its stream state
    uninitialised, and ``ix_open`` then crashes writing the FASTA index.
    A failed build is left to ``_open_extractor``, which reports it and
    falls back to the Python extractor."""
    if not os.path.exists(library_path()):
        env = {k: v for k, v in os.environ.items() if k != "CXX"}
        try:
            subprocess.run(["make", "-C", os.path.dirname(library_path()),
                            "-s"], env=env, capture_output=True, text=True)
        except OSError:
            pass  # no make: _open_extractor reports it and falls back
    return _open_extractor(paf, fasta)
