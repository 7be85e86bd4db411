"""AGC archive ingestion.

The reference's data substrate is a single AGC archive of 465 HPRC
assemblies, passed to every ``impg`` invocation as ``--sequence-files *.agc``
(reference run_pica2_impg.sh:162-168, doc/where_hprc_data.md:14-26).  AGC is
a bespoke compressed container (refresh-bio/agc) whose format has no public
spec; re-implementing its segment/splitter decoder from scratch was
considered and descoped — instead this module provides a first-class,
one-command conversion to a random-access BGZF FASTA store using the ``agc``
tool itself (the one external binary the data distribution already requires
to exist), after which the engine never touches AGC again:

    impop-tpu import-agc hprc.agc -o store.fa.gz

Every command also accepts ``--agc`` directly: the conversion runs once and
is cached next to the archive (``<archive>.impop.fa.gz``), so
``scan --paf aln.paf.gz --agc hprc.agc`` works on HPRC-format inputs with no
external ``impg``.

The converted store is written with the in-repo BGZF writer
(impop_tpu_torch/io/bgzf.py) and random-accessed by the C++ FastaReader
(cpp/fasta.cc) through samtools-compatible ``.fai``/``.gzi`` indexes.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
from typing import List, Optional, Sequence

__all__ = [
    "agc_available",
    "list_samples",
    "convert_agc",
    "ensure_fasta_store",
]

_STREAM_CHUNK = 1 << 20


def agc_available(agc_bin: str = "agc") -> bool:
    return shutil.which(agc_bin) is not None


def _require_agc(agc_bin: str) -> None:
    if not agc_available(agc_bin):
        raise RuntimeError(
            f"'{agc_bin}' binary not found. AGC is a bespoke compressed "
            "container; converting it requires the agc tool "
            "(github.com/refresh-bio/agc) on PATH once — after conversion "
            "the engine uses only the BGZF FASTA store. Alternatively pass "
            "--fasta with an existing (optionally bgzip-compressed) store."
        )


def list_samples(archive: str, agc_bin: str = "agc") -> List[str]:
    """Sample (assembly) names in the archive, via ``agc listset``."""
    _require_agc(agc_bin)
    proc = subprocess.run([agc_bin, "listset", archive],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"agc listset failed: {proc.stderr.strip()}")
    return [ln.strip() for ln in proc.stdout.splitlines() if ln.strip()]


def _stream_fasta(cmd: Sequence[str], writer, rename_prefix: Optional[str],
                  agc_bin: str) -> None:
    """Run an agc extraction command, streaming stdout into the BGZF writer.

    ``rename_prefix`` prepends ``<sample>#`` to each header line — used when
    contig names alone would collide across assemblies (non-PanSN naming).
    """
    proc = subprocess.Popen(list(cmd), stdout=subprocess.PIPE)
    assert proc.stdout is not None
    pending = b""
    try:
        while True:
            chunk = proc.stdout.read(_STREAM_CHUNK)
            if not chunk:
                break
            if rename_prefix is None:
                writer.write(chunk)
                continue
            pending += chunk
            lines = pending.split(b"\n")
            pending = lines.pop()
            for line in lines:
                if line.startswith(b">"):
                    line = b">" + rename_prefix.encode() + line[1:]
                writer.write(line + b"\n")
        if pending:
            if rename_prefix is not None and pending.startswith(b">"):
                pending = b">" + rename_prefix.encode() + pending[1:]
            writer.write(pending)
    finally:
        proc.stdout.close()
        rc = proc.wait()
    if rc != 0:
        raise RuntimeError(f"{agc_bin} {' '.join(cmd[1:3])} failed (rc={rc})")


def convert_agc(
    archive: str,
    out_path: str,
    samples: Optional[Sequence[str]] = None,
    agc_bin: str = "agc",
    prefix_sample: bool = False,
    quiet: bool = False,
) -> str:
    """AGC archive → BGZF FASTA store at ``out_path``.

    With no sample subset and no renaming, one streaming ``agc getcol``
    handles the whole collection; otherwise one ``agc getset`` per sample.
    """
    from impop_tpu_torch.io.bgzf import BgzfWriter

    _require_agc(agc_bin)
    tmp = out_path + ".tmp"
    with open(tmp, "wb") as fh, BgzfWriter(fh) as bw:
        if samples is None and not prefix_sample:
            _stream_fasta([agc_bin, "getcol", archive], bw, None, agc_bin)
        else:
            names = list(samples) if samples is not None \
                else list_samples(archive, agc_bin)
            for i, sample in enumerate(names):
                if not quiet:
                    print(f"[import-agc] {i + 1}/{len(names)} {sample}",
                          file=sys.stderr)
                _stream_fasta(
                    [agc_bin, "getset", archive, sample], bw,
                    f"{sample}#" if prefix_sample else None, agc_bin,
                )
    os.replace(tmp, out_path)
    return out_path


def _iter_fasta_md5(stream):
    """Yield (record name, md5 of case-normalised sequence bytes)."""
    import hashlib

    name, h = None, None
    for line in stream:
        if line.startswith(b">"):
            if name is not None:
                yield name, h.hexdigest()
            name = line[1:].split()[0].decode()
            h = hashlib.md5()
        elif name is not None:
            h.update(line.strip().upper())
    if name is not None:
        yield name, h.hexdigest()


def verify_store(archive: str, store_path: str, agc_bin: str = "agc",
                 samples: Optional[Sequence[str]] = None,
                 quiet: bool = False) -> int:
    """Checksum round-trip of a converted store against the archive.

    Streams every sample back out of the AGC archive and checks that each
    sequence exists in the BGZF store with identical (case-normalised)
    bytes — the one-command validation a user with the real HPRC archive
    runs after ``import-agc`` (reference doc/where_hprc_data.md:14-26 is
    the substrate being converted).  Returns the number of sequences
    checked; raises RuntimeError listing the first mismatches.
    """
    import gzip

    _require_agc(agc_bin)
    store = {}
    with gzip.open(store_path, "rb") as fh:
        for name, digest in _iter_fasta_md5(fh):
            store[name] = digest
    names = (list(samples) if samples is not None
             else list_samples(archive, agc_bin))
    checked = 0
    mismatches: List[str] = []
    for i, sample in enumerate(names):
        if not quiet:
            print(f"[verify-agc] {i + 1}/{len(names)} {sample}",
                  file=sys.stderr)
        proc = subprocess.Popen([agc_bin, "getset", archive, sample],
                                stdout=subprocess.PIPE)
        assert proc.stdout is not None
        for name, digest in _iter_fasta_md5(proc.stdout):
            if store.get(name) != digest:
                mismatches.append(name)
            checked += 1
        if proc.wait() != 0:
            raise RuntimeError(f"agc getset {sample} failed")
    if mismatches:
        raise RuntimeError(
            f"store does not match archive: {len(mismatches)} sequence(s) "
            f"differ or are missing (first: {mismatches[:5]})"
        )
    if checked == 0:
        raise RuntimeError("archive produced no sequences to verify")
    return checked


def ensure_fasta_store(archive: str, agc_bin: str = "agc",
                       quiet: bool = False) -> str:
    """Cached conversion: ``<archive>.impop.fa.gz`` next to the archive
    (or under $IMPOP_TPU_AGC_CACHE when the archive's directory is
    read-only), created on first use."""
    cache_dir = os.environ.get("IMPOP_TPU_AGC_CACHE")
    base = (os.path.join(cache_dir, os.path.basename(archive))
            if cache_dir else archive)
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
    out = base + ".impop.fa.gz"
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(archive):
        return out
    if not quiet:
        print(f"[import-agc] converting {archive} -> {out} (one-time)",
              file=sys.stderr)
    return convert_agc(archive, out, agc_bin=agc_bin, quiet=quiet)
