"""Minimal BGZF (bgzip) writer.

BGZF is the blocked-gzip variant used across genomics (htslib/samtools): a
sequence of independent gzip members, each at most 64 KiB of payload, whose
FEXTRA field carries the compressed block size — which is what makes random
access possible.  The reference pipeline's data substrate is bgzip FASTA
converted from the HPRC AGC archive (reference doc/where_hprc_data.md:14-26);
the C++ FastaReader (cpp/fasta.cc) random-accesses these via a block index.

This writer exists because the environment ships no ``bgzip`` binary: the
``import-agc`` conversion path and the extraction tests both need to *produce*
BGZF.  Reading is done natively in C++ (cpp/fasta.cc) or transparently by
zlib/gzip (BGZF is valid multi-member gzip).
"""
from __future__ import annotations

import struct
import zlib
from typing import BinaryIO, Iterable, Union

__all__ = ["bgzf_block", "BGZF_EOF", "BgzfWriter", "write_bgzf"]

# Fixed empty block marking end-of-file (htslib convention).
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)

# Payload bytes per block; htslib uses 0xff00 so the compressed block always
# fits in the 16-bit BSIZE field even if deflate expands the data.
BLOCK_PAYLOAD = 0xFF00


def bgzf_block(payload: bytes, level: int = 6) -> bytes:
    """One BGZF block: gzip member with the BC extra subfield."""
    if len(payload) > 0x10000:
        raise ValueError("BGZF payload exceeds 64 KiB")
    co = zlib.compressobj(level, zlib.DEFLATED, -15)  # raw deflate
    deflated = co.compress(payload) + co.flush()
    bsize = 12 + 6 + len(deflated) + 8  # header + extra + data + crc/isize
    header = struct.pack(
        "<BBBBIBBHBBHH",
        0x1F, 0x8B, 8, 4,      # magic, deflate, FEXTRA
        0,                     # mtime
        0, 0xFF,               # XFL, OS=unknown
        6,                     # XLEN
        66, 67, 2,             # 'B', 'C', SLEN=2
        bsize - 1,             # BSIZE
    )
    tail = struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF,
                       len(payload) & 0xFFFFFFFF)
    return header + deflated + tail


class BgzfWriter:
    """Streamed BGZF writer: buffers to BLOCK_PAYLOAD, emits blocks."""

    def __init__(self, fh: BinaryIO, level: int = 6):
        self._fh = fh
        self._level = level
        self._buf = bytearray()

    def write(self, data: Union[bytes, str]) -> None:
        if isinstance(data, str):
            data = data.encode()
        self._buf.extend(data)
        while len(self._buf) >= BLOCK_PAYLOAD:
            self._fh.write(bgzf_block(bytes(self._buf[:BLOCK_PAYLOAD]),
                                      self._level))
            del self._buf[:BLOCK_PAYLOAD]

    def close(self) -> None:
        if self._buf:
            self._fh.write(bgzf_block(bytes(self._buf), self._level))
            self._buf.clear()
        self._fh.write(BGZF_EOF)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_bgzf(path: str, chunks: Iterable[Union[bytes, str]],
               level: int = 6) -> None:
    """Write an iterable of chunks to ``path`` as BGZF."""
    with open(path, "wb") as fh, BgzfWriter(fh, level) as bw:
        for chunk in chunks:
            bw.write(chunk)
