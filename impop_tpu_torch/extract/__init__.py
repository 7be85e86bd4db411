"""Python interface to the native extraction layer (the port's copy of
``impop_tpu/extract/__init__.py``; only the build of the library and the
batch metadata calls of :class:`NativeBatch` differ).

The C++ library (cpp/) replaces the capabilities the reference consumes from
impg / odgi / povu (SURVEY.md §2.2): PAF+CIGAR window projection over a FASTA
sequence store, producing the haplotype-by-site allele matrices that feed the
statistics.  Binding is ctypes over a plain C ABI.

The library is built from the repository's ``cpp/*.cc`` and the port's own
``batchmeta.cc`` (beside this file) at first use, by
:func:`library_path`, with the system ``g++`` and the flags of
``cpp/Makefile``, into ``impop_tpu_torch/_build/`` under a name keyed by a
hash of the sources and the flags.  It never inherits ``$CXX`` (a toolchain
that links libstdc++ statically into the shared object leaves its stream
state uninitialised, and ``ix_open`` then crashes writing the FASTA index)
and never writes into ``cpp/``.  ``sanitize`` (of :func:`library_path`,
:func:`load_library` and :class:`NativeExtractor`) selects an instrumented
variant (``address`` or ``thread``, the flags of ``cpp/Makefile``'s
``asan`` / ``tsan`` targets at ``-O1``), built beside the production
library under its own name; a process that loads it must have the
sanitizer's runtime preloaded (``python -m impop_tpu_torch.bench.ci_extract``
runs the smoke that way).  A pure Python fallback
(:mod:`impop_tpu_torch.extract.pyfallback`) implements the same projection
for environments without a compiler.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import struct
import subprocess
import tempfile
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

__all__ = ["WindowMatrix", "NativeExtractor", "load_library", "library_path", "SANITIZERS", "split_window_matrix", "site_weights_from_keys"]

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_CPP_DIR = os.path.join(_REPO_ROOT, "cpp")
_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
_CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-pthread"]
_LDFLAGS = ["-shared", "-lz", "-pthread"]
# the instrumented variants: compile flags after _CXXFLAGS (-O1 wins over
# -O3), and -fsanitize at the link as well
SANITIZERS = {"address": ["-fsanitize=address", "-g", "-O1"],
              "thread": ["-fsanitize=thread", "-g", "-O1"]}


class WindowMatrix(NamedTuple):
    names: List[str]       # sorted haplotype row names ("contig:qs-qe")
    site_keys: List[str]   # "pos:ref>alt" per column
    site_pos: np.ndarray   # [s] int64 target positions
    geno: np.ndarray       # [n, s] int8; 1 alt, 0 ref, -1 uncovered


def _cpp_sources() -> List[str]:
    """``cpp/*.cc``, then the port's sources beside this file."""
    return (sorted(glob.glob(os.path.join(_CPP_DIR, "*.cc")))
            + sorted(glob.glob(os.path.join(_HERE, "*.cc"))))


def _flags(sanitize: Optional[str]):
    """(compile flags, link flags) of the production library or of a
    sanitizer variant."""
    if sanitize is None:
        return _CXXFLAGS, _LDFLAGS
    if sanitize not in SANITIZERS:
        raise ValueError(f"unknown sanitizer {sanitize!r}; one of "
                         f"{sorted(SANITIZERS)}")
    return (_CXXFLAGS + SANITIZERS[sanitize],
            _LDFLAGS + [f"-fsanitize={sanitize}"])


def _lib_target(sanitize: Optional[str] = None) -> str:
    cxx, ld = _flags(sanitize)
    h = hashlib.sha256(" ".join(cxx + ld).encode())
    for path in _cpp_sources() + sorted(glob.glob(os.path.join(_CPP_DIR, "*.h"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    kind = "" if sanitize is None else f"{sanitize}-"
    return os.path.join(_BUILD_DIR,
                        f"libimpop_extract-{kind}{h.hexdigest()[:16]}.so")


def library_path(sanitize: Optional[str] = None) -> str:
    """The native library (``sanitize``: that instrumented variant), built
    from :func:`_cpp_sources` when it is not built yet (one ``g++ -c`` per
    source, all at once, then one link; the library is renamed into place only
    when every step succeeded).  Raises on a failed build."""
    target = _lib_target(sanitize)
    if os.path.exists(target):
        return target
    cxx, ld = _flags(sanitize)
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # g++ runs without a sanitizer runtime the caller may have preloaded
    env = {k: v for k, v in os.environ.items() if k != "LD_PRELOAD"}
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as work:
        srcs = _cpp_sources()
        objs = [os.path.join(work, os.path.basename(src) + ".o") for src in srcs]
        procs = [subprocess.Popen(["g++", *cxx, "-c", src, "-o", obj],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True,
                                  env=env)
                 for src, obj in zip(srcs, objs)]
        failed = []
        for src, proc in zip(srcs, procs):
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{os.path.basename(src)}:\n{out}")
        if failed:
            raise RuntimeError("g++ failed:\n" + "\n".join(failed))
        tmp = os.path.join(work, "lib.so")
        subprocess.run(["g++", *objs, *ld, "-o", tmp], check=True,
                       capture_output=True, text=True, env=env)
        os.replace(tmp, target)
    return target


# the loaded libraries by variant (None: production)
_libs: Dict[Optional[str], ctypes.CDLL] = {}


def load_library(rebuild: bool = False,
                 sanitize: Optional[str] = None) -> ctypes.CDLL:
    """The production library, or the variant built with sanitizer
    ``sanitize`` ("address" or "thread"; the process needs that runtime
    preloaded), built and bound on first use."""
    if sanitize in _libs and not rebuild:
        return _libs[sanitize]
    if rebuild and os.path.exists(_lib_target(sanitize)):
        os.remove(_lib_target(sanitize))
    lib = ctypes.CDLL(library_path(sanitize))
    lib.ix_open.restype = ctypes.c_void_p
    lib.ix_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.ix_error.restype = ctypes.c_char_p
    lib.ix_error.argtypes = [ctypes.c_void_p]
    lib.ix_close.argtypes = [ctypes.c_void_p]
    lib.ix_extract.restype = ctypes.c_void_p
    lib.ix_extract.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_longlong),
    ]
    lib.ix_copy_geno.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_byte)]
    lib.ix_name.restype = ctypes.c_char_p
    lib.ix_name.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    lib.ix_site_key.restype = ctypes.c_char_p
    lib.ix_site_key.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    lib.ix_site_pos.restype = ctypes.c_longlong
    lib.ix_site_pos.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    lib.ix_copy_site_pos.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong)
    ]
    lib.ix_names_blob.restype = ctypes.c_char_p
    lib.ix_names_blob.argtypes = [ctypes.c_void_p]
    lib.ix_site_keys_blob.restype = ctypes.c_char_p
    lib.ix_site_keys_blob.argtypes = [ctypes.c_void_p]
    lib.ix_result_free.argtypes = [ctypes.c_void_p]
    lib.ix_extract_batch.restype = ctypes.c_void_p
    lib.ix_extract_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_longlong),
        ctypes.c_longlong, ctypes.c_int,
    ]
    lib.ix_batch_dims.restype = ctypes.c_int
    lib.ix_batch_dims.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_longlong),
    ]
    lib.ix_batch_error.restype = ctypes.c_char_p
    lib.ix_batch_error.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    lib.ix_batch_result.restype = ctypes.c_void_p
    lib.ix_batch_result.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    lib.ix_batch_fill.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.POINTER(ctypes.c_byte),
        ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_ubyte),
        ctypes.POINTER(ctypes.c_float), ctypes.c_longlong, ctypes.c_longlong,
    ]
    lib.ix_batch_fill_all.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_byte),
        ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_ubyte),
        ctypes.POINTER(ctypes.c_float), ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int,
    ]
    lib.ix_batch_pack_all.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int,
    ]
    lib.ix_batch_row_sets.restype = ctypes.c_longlong
    lib.ix_batch_row_sets.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_longlong),
    ]
    lib.ix_batch_nearest_sites.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_longlong),
    ]
    lib.ix_batch_free.argtypes = [ctypes.c_void_p]
    _libs[sanitize] = lib
    return lib


def _ll_ptr(arr: np.ndarray):
    """A contiguous int64 array as a ``long long*``."""
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong))


class NativeBatch:
    """Open handle to one extracted window batch (ix_extract_batch).

    Splits ``extract_batch_padded``'s extract-then-read into two pipeline
    stages: the scan's extraction worker opens the batch (the C record
    walk happens there), and the build worker later packs it STRAIGHT
    into the fused scan wire buffer with :meth:`pack_into`
    (ix_batch_pack_all) — no intermediate [w, cap_n, cap_s] int8 tiles,
    no numpy bit-packing passes on the CPU-starved host.
    """

    def __init__(self, lib, handle, count: int):
        self._lib = lib
        self._handle = handle
        self.count = count
        self.dims: List[tuple] = []
        self.errors: List[str] = [""] * count
        n = ctypes.c_longlong()
        s = ctypes.c_longlong()
        for i in range(count):
            if lib.ix_batch_dims(handle, i, ctypes.byref(n),
                                 ctypes.byref(s)) != 0:
                err = lib.ix_batch_error(handle, i)
                self.errors[i] = err.decode() if err else "unknown"
                self.dims.append((0, 0))
            else:
                self.dims.append((n.value, s.value))

    def names_blob(self, i: int) -> bytes:
        """Row names of window i as the native blob: each name and a
        newline, in the rows' sorted order."""
        res = self._lib.ix_batch_result(self._handle, i)
        return self._lib.ix_names_blob(res) or b""

    def site_pos(self, i: int) -> np.ndarray:
        """Absolute variant positions of window i's site columns."""
        n, s = self.dims[i]
        out = np.zeros(max(s, 1), np.int64)
        if s:
            res = self._lib.ix_batch_result(self._handle, i)
            self._lib.ix_copy_site_pos(
                res, out.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_longlong)))
        return out[:s]

    def row_sets(self, regions: Sequence[str]) -> Tuple[np.ndarray,
                                                         np.ndarray]:
        """The windows grouped by row set (ix_batch_row_sets of
        ``batchmeta.cc``): two windows share one when their name blobs are
        equal with each one's reference row, its first name equal to its
        region string ``regions[i]``, blanked in place, as
        ``scanrun.PanelMasks.row_set_key`` keys them.  Returns
        ``(set_of, first)``: the set of each window (-1 for a failed one)
        and the first window of each set, sets in their first window's
        order."""
        if len(regions) != self.count:
            raise ValueError(f"{len(regions)} region strings for "
                             f"{self.count} windows")
        if not self.count:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        c_regions = (ctypes.c_char_p * self.count)(
            *[rs.encode() for rs in regions])
        set_of = np.empty(self.count, np.int64)
        first = np.empty(self.count, np.int64)
        n_sets = self._lib.ix_batch_row_sets(
            self._handle, self.count, c_regions, _ll_ptr(set_of),
            _ll_ptr(first))
        return set_of, first[:n_sets]

    def nearest_sites(self, targets: np.ndarray) -> Tuple[np.ndarray,
                                                          np.ndarray]:
        """For each window, the index of the site nearest ``targets[i]``
        (the first of equally near sites, as ``np.argmin``) and that site's
        position (ix_batch_nearest_sites); -1 and -1 for a window without
        sites or a failed one."""
        targets = np.ascontiguousarray(targets, np.int64)
        if targets.shape != (self.count,):
            raise ValueError(f"targets of shape {targets.shape} for "
                             f"{self.count} windows")
        index = np.full(self.count, -1, np.int64)
        pos = np.full(self.count, -1, np.int64)
        if self.count:
            self._lib.ix_batch_nearest_sites(
                self._handle, self.count, _ll_ptr(targets), _ll_ptr(index),
                _ll_ptr(pos))
        return index, pos

    def pack_into(self, flat: np.ndarray, out_rows, cap_n: int, cap_s: int,
                  o_m: int, o_sm: int, o_w: int = -1,
                  threads: int = 0) -> None:
        """Pack every window into the pre-zeroed [W, stride] uint8 wire
        buffer ``flat`` (layout: cli._scan_buf_layout); ``out_rows[i]`` is
        window i's buffer row, -1 to skip (failed windows)."""
        assert flat.dtype == np.uint8 and flat.flags.c_contiguous
        rows = (ctypes.c_longlong * self.count)(*out_rows)
        self._lib.ix_batch_pack_all(
            self._handle,
            flat.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            flat.strides[0], rows, cap_n, cap_s, o_m, o_sm, o_w, threads)

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.ix_batch_free(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# the sidecar header of cpp/paf.cc (IdxHeader: magic, version, the PAF's
# size and mtime, the record count) and the smallest record it can hold:
# two name lengths, seven int64 fields, the strand byte and an op count
_IDX_HEADER = struct.Struct("<4sIqqqQ")
_IDX_MIN_RECORD = 4 + 4 + 8 * 3 + 1 + 8 * 3 + 8
_OPEN_LOCK = threading.Lock()


def _sidecar_overclaims(paf_path: str) -> bool:
    """True when ``<paf>.impopidx`` has the magic and version the C++ loads
    but claims more records than the bytes after its header can hold.  The
    C++ sizes its record table from that count before any bounds check, so
    a bogus count makes ``ix_open`` fail instead of reparsing the PAF."""
    path = paf_path + ".impopidx"
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as fh:
            head = fh.read(_IDX_HEADER.size)
    except OSError:
        return False
    if len(head) < _IDX_HEADER.size:
        return False
    magic, version, _, _, _, n_records = _IDX_HEADER.unpack(head)
    return (magic == b"IPXI" and version == 1
            and n_records * _IDX_MIN_RECORD > size - _IDX_HEADER.size)


def _range_walkable(wins) -> bool:
    """Whether ``ix_extract_batch`` serves the batch with its range walker:
    every window non-empty, each starting at or after the last one's end
    (``cpp/capi.cc``).  Any other batch, or one whose range walk fails, is
    extracted window by window."""
    return all(e > s for s, e in wins) and all(
        b[0] >= a[1] for a, b in zip(wins, wins[1:]))


class NativeExtractor:
    """PAF + FASTA → per-window allele matrices (C++ fast path).

    A sidecar index whose header overclaims its record count is bypassed:
    the PAF is opened with ``IMPOP_PAF_INDEX=0`` for the duration of the
    call, so the C++ reparses it and neither loads nor rewrites the
    sidecar.

    Each extractor times its native calls (ctypes lets go of the
    interpreter lock for a call, so a call's wall is its native time, with
    the wait to take the lock back) and counts the extractors open in the
    process: :meth:`stats`."""

    open_count = 0      # extractors opened and not yet closed

    def __init__(self, paf_path: str, fasta_path: str,
                 sanitize: Optional[str] = None):
        self._lib = load_library(sanitize=sanitize)
        bypass = _sidecar_overclaims(paf_path)
        # the C++ reads the process environment while it opens (and may
        # write the sidecar), so opens take turns: no other open sees the
        # bypass, and the restore cannot race with one
        with _OPEN_LOCK:
            saved = os.environ.get("IMPOP_PAF_INDEX")
            if bypass:
                os.environ["IMPOP_PAF_INDEX"] = "0"
            try:
                t0 = time.perf_counter_ns()
                self._handle = self._lib.ix_open(
                    paf_path.encode(), fasta_path.encode()
                )
                self._open_ns = time.perf_counter_ns() - t0
            finally:
                if bypass and saved is None:
                    del os.environ["IMPOP_PAF_INDEX"]
                elif bypass:
                    os.environ["IMPOP_PAF_INDEX"] = saved
        err = self._lib.ix_error(self._handle)
        if err:
            msg = err.decode()
            self._lib.ix_close(self._handle)
            self._handle = None
            raise RuntimeError(f"extractor open failed: {msg}")
        with _OPEN_LOCK:
            NativeExtractor.open_count += 1
            self._open_gauge = NativeExtractor.open_count
        self._lock = threading.Lock()
        self._extract_ns = self._range_windows = self._fallback_windows = 0

    def close(self) -> None:
        if self._handle is not None:
            self._lib.ix_close(self._handle)
            self._handle = None
            with _OPEN_LOCK:
                NativeExtractor.open_count -= 1

    def stats(self) -> Dict[str, int]:
        """The extractor's clock and counts, under the scan's counter
        names: ``open.native_ns`` (the wall of its native open),
        ``extractors.open`` (the extractors open in the process once it
        had opened, itself included) and, over its batch extractions so
        far, ``extract.native_ns`` (the native calls' walls),
        ``extract.range_windows`` (windows of sorted, non-overlapping
        batches, which the range walker serves) and ``extract.fallback_windows`` (windows of the others,
        unsorted or overlapping, extracted one by one)."""
        with self._lock:
            return {"open.native_ns": self._open_ns,
                    "extractors.open": self._open_gauge,
                    "extract.native_ns": self._extract_ns,
                    "extract.range_windows": self._range_windows,
                    "extract.fallback_windows": self._fallback_windows}

    def _extract_batch(self, target: str, wins, threads: int):
        """One ``ix_extract_batch`` call over ``wins``, a non-empty list of
        (start, end), timed and counted for :meth:`stats`: the open native
        batch."""
        count = len(wins)
        starts = (ctypes.c_longlong * count)(*[s for s, _ in wins])
        ends = (ctypes.c_longlong * count)(*[e for _, e in wins])
        t0 = time.perf_counter_ns()
        batch = self._lib.ix_extract_batch(
            self._handle, target.encode(), starts, ends, count, threads
        )
        dt = time.perf_counter_ns() - t0
        if not batch:
            raise RuntimeError(f"extract_batch failed for {target}")
        ranged = _range_walkable(wins)
        with self._lock:
            self._extract_ns += dt
            if ranged:
                self._range_windows += count
            else:
                self._fallback_windows += count
        return batch

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _read_result(self, res, n_v: int, s_v: int) -> WindowMatrix:
        geno = np.full((n_v, max(s_v, 1)), -1, dtype=np.int8)
        if n_v:
            buf = geno.ctypes.data_as(ctypes.POINTER(ctypes.c_byte))
            self._lib.ix_copy_geno(res, buf)
        geno = geno[:, :s_v] if s_v else geno[:, :0]
        # bulk reads: one joined blob / one array copy per field instead
        # of n+2s ctypes round trips (dominates at ~1e6 sites)
        nb = self._lib.ix_names_blob(res)
        names = nb.decode().splitlines() if n_v and nb else []
        kb = self._lib.ix_site_keys_blob(res)
        site_keys = kb.decode().splitlines() if s_v and kb else []
        site_pos = np.zeros(s_v, dtype=np.int64)
        if s_v:
            self._lib.ix_copy_site_pos(
                res, site_pos.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_longlong))
            )
        return WindowMatrix(names, site_keys, site_pos, geno)

    def extract(self, target: str, start: int, end: int) -> WindowMatrix:
        n = ctypes.c_longlong()
        s = ctypes.c_longlong()
        res = self._lib.ix_extract(
            self._handle, target.encode(), start, end,
            ctypes.byref(n), ctypes.byref(s),
        )
        if not res:
            err = self._lib.ix_error(self._handle)
            raise RuntimeError(
                f"extract failed for {target}:{start}-{end}: "
                f"{err.decode() if err else 'unknown'}"
            )
        try:
            return self._read_result(res, n.value, s.value)
        finally:
            self._lib.ix_result_free(res)

    def extract_batch(self, target: str, windows,
                      threads: int = 0) -> List[Optional[WindowMatrix]]:
        """Extract a batch of windows in ONE native call.

        Sorted, non-overlapping batches (the tiled-scan common case) take
        the range fast path: one CIGAR walk per PAF record for the whole
        batch instead of one per (record, window) — the host-side analogue
        of batching windows onto the device.  Returns one WindowMatrix per
        window, or None for a window whose extraction failed (its message
        is reported via ``errors``, parallel list attribute on the return's
        ``.errors`` — see below).

        The return value is a plain list; per-window failures are recorded
        as None entries and the corresponding messages are available from
        :meth:`last_errors` until the next batch call.
        """
        wins = [(int(s), int(e)) for s, e in windows]
        count = len(wins)
        self.last_errors: List[str] = [""] * count
        if count == 0:
            return []
        batch = self._extract_batch(target, wins, threads)
        try:
            out: List[Optional[WindowMatrix]] = []
            n = ctypes.c_longlong()
            s = ctypes.c_longlong()
            for i in range(count):
                if self._lib.ix_batch_dims(batch, i, ctypes.byref(n),
                                           ctypes.byref(s)) != 0:
                    err = self._lib.ix_batch_error(batch, i)
                    self.last_errors[i] = err.decode() if err else "unknown"
                    out.append(None)
                    continue
                res = self._lib.ix_batch_result(batch, i)
                out.append(self._read_result(res, n.value, s.value))
            return out
        finally:
            self._lib.ix_batch_free(batch)

    def extract_batch_open(self, target: str, windows,
                           threads: int = 0) -> "NativeBatch":
        """Run the batch extraction and return the OPEN native handle.

        The scan's two-stage pipeline calls this on the extraction worker
        (the C record walk runs here) and later wire-packs the result on
        the build worker via :meth:`NativeBatch.pack_into` — see
        cli.extract_native.  Sorted non-overlapping batches take the
        range walker inside (one CIGAR walk per PAF record per batch).
        """
        wins = [(int(s), int(e)) for s, e in windows]
        count = len(wins)
        if count == 0:
            return NativeBatch(self._lib, None, 0)
        return NativeBatch(self._lib,
                           self._extract_batch(target, wins, threads), count)

    def extract_batch_padded(self, target: str, windows, threads: int = 0,
                             min_cap_n: int = 1, min_cap_s: int = 128,
                             want_weights: bool = False):
        """One native call → padded scan-ready tiles for a window batch.

        Returns ``(geno [w,cap_n,cap_s] int8, member [w,cap_n] bool,
        smask [w,cap_s] bool, wts [w,cap_s] f32 or None, names per window,
        errors per window)`` with the padding/masking loops (and, when
        ``want_weights``, the identity-weight key parsing) done in C++ —
        the per-window numpy assembly dominated the Python profile once the
        extraction itself was range-batched.  ``cap_s`` is rounded up to a
        multiple of 128 (device lane width); ``cap_n`` is the batch max.
        Failed windows get all-False member rows and their message in
        ``errors``; names lists are deduplicated across windows (a scan
        over one region typically has one shared row set).
        """
        wins = [(int(s), int(e)) for s, e in windows]
        count = len(wins)
        if count == 0:
            return (np.zeros((0, 0, 0), np.int8), np.zeros((0, 0), bool),
                    np.zeros((0, 0), bool), None, [], [])
        batch = self._extract_batch(target, wins, threads)
        try:
            n_c = ctypes.c_longlong()
            s_c = ctypes.c_longlong()
            dims = []
            errors: List[str] = [""] * count
            for i in range(count):
                if self._lib.ix_batch_dims(batch, i, ctypes.byref(n_c),
                                           ctypes.byref(s_c)) != 0:
                    err = self._lib.ix_batch_error(batch, i)
                    errors[i] = err.decode() if err else "unknown"
                    dims.append((0, 0))
                else:
                    dims.append((n_c.value, s_c.value))
            cap_n = max(min_cap_n, max((n for n, _ in dims), default=1) or 1)
            cap_s = max(min_cap_s,
                        max((s for _, s in dims), default=1) or 1)
            cap_s = ((cap_s + 127) // 128) * 128
            geno = np.full((count, cap_n, cap_s), -1, dtype=np.int8)
            member = np.zeros((count, cap_n), dtype=np.uint8)
            smask = np.zeros((count, cap_s), dtype=np.uint8)
            wts = (np.ones((count, cap_s), dtype=np.float32)
                   if want_weights else None)
            null_f = ctypes.POINTER(ctypes.c_float)()
            # one parallel C call fills every window's padded tile (failed
            # windows are null results inside and stay at the -1/0 padding)
            self._lib.ix_batch_fill_all(
                batch,
                geno.ctypes.data_as(ctypes.POINTER(ctypes.c_byte)),
                member.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                smask.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                wts.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
                if want_weights else null_f,
                cap_n, cap_s, threads,
            )
            names: List[List[str]] = []
            blob_cache: dict = {}
            for i in range(count):
                if dims[i] == (0, 0) and errors[i]:
                    names.append([])
                    continue
                res = self._lib.ix_batch_result(batch, i)
                blob = self._lib.ix_names_blob(res) or b""
                cached = blob_cache.get(blob)
                if cached is None:
                    cached = blob.decode().splitlines()
                    blob_cache[blob] = cached
                names.append(cached)
            return (geno, member.view(bool), smask.view(bool), wts, names,
                    errors)
        finally:
            self._lib.ix_batch_free(batch)


def site_weights_from_keys(site_keys) -> np.ndarray:
    """Column-mode identity weights from variant keys ("pos:ref>alt").

    A SNP weighs 1 alignment column; an indel of k bases weighs k (gap
    columns in a pairwise alignment).  Placeholder alleles from windows
    without query sequence (``<INSk>``) decode their stored length.  See
    doc/how_stats.md "Identity definition and impg parity".
    """
    w = np.ones(len(site_keys), dtype=np.float32)
    for i, key in enumerate(site_keys):
        _, rest = key.split(":", 1)
        ref, alt = rest.split(">", 1)
        if alt.startswith("<INS") and alt.endswith(">"):
            try:
                alt = "N" * int(alt[4:-1])
            except ValueError:
                pass
        w[i] = max(len(ref), len(alt), 1)
    return w


def split_window_matrix(wm: WindowMatrix, windows) -> List[WindowMatrix]:
    """Slice one range-extracted WindowMatrix into per-window matrices.

    A tiled scan (the common case: thousands of adjacent windows) only needs
    ONE CIGAR walk per alignment for the whole range; each window is then a
    site-column slice (coverage is already encoded per cell as -1).  This
    removes the per-window re-walk the reference performs with one impg
    process per window.

    Args:
      windows: iterable of (start, end) target intervals
    """
    out = []
    pos = np.asarray(wm.site_pos)
    # insertions ("pos:>ALT", empty ref) follow the extractor's boundary
    # rule start < pos <= end (cpp/window.cc 'I' case); other variants use
    # start <= pos < end
    is_ins = np.asarray([k.split(":", 1)[1].startswith(">")
                         for k in wm.site_keys], dtype=bool)
    for start, end in windows:
        in_win = np.where(
            is_ins, (pos > start) & (pos <= end), (pos >= start) & (pos < end)
        )
        cols = np.nonzero(in_win)[0]
        out.append(WindowMatrix(
            names=wm.names,
            site_keys=[wm.site_keys[c] for c in cols],
            site_pos=pos[cols],
            geno=wm.geno[:, cols] if len(cols) else wm.geno[:, :0],
        ))
    return out
