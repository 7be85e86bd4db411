"""Synthetic pangenome generator — test/bench data for the extraction layer.

Plants known SNPs/indels into haplotype copies of a random reference, writes
the FASTA + PAF(+CIGAR) pair the extractor consumes, and returns the ground
truth for assertions.  Serves the role of the reference's executable fixture
(example_fst_methods.py) one layer lower in the stack.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

_BASES = np.array(list("ACGT"))
_COMP = str.maketrans("ACGT", "TGCA")


@dataclasses.dataclass
class SimHaplotype:
    name: str
    target_start: int            # aligned span on the reference
    target_end: int
    reverse: bool
    snps: Dict[int, str]         # target pos -> alt base
    insertions: Dict[int, str]   # target pos (before which) -> inserted seq
    deletions: Dict[int, int]    # target pos -> deleted length


@dataclasses.dataclass
class SimPangenome:
    ref_name: str
    ref_seq: str
    haplotypes: List[SimHaplotype]
    fasta_path: str
    paf_path: str


def _revcomp(seq: str) -> str:
    return seq.translate(_COMP)[::-1]


def simulate(
    out_dir: str,
    ref_len: int = 2000,
    n_haps: int = 6,
    n_snps: int = 5,
    p_indel: float = 0.5,
    ref_name: str = "CHM13#0#chr1",
    seed: int = 0,
    span: Optional[Tuple[int, int]] = None,
    site_pool: Optional[int] = None,
) -> SimPangenome:
    """With ``site_pool=k``, variation is drawn from a SHARED pool of k sites
    (same alt allele per site, per-site carrier frequencies) — the realistic
    pangenome shape, where the window site-axis is the pool, not
    n_haps x n_snps independent private variants.  ``n_snps`` is ignored in
    pool mode."""
    import os

    rng = np.random.default_rng(seed)
    ref_seq = "".join(rng.choice(_BASES, size=ref_len))
    haps: List[SimHaplotype] = []
    fasta_records: List[Tuple[str, str]] = [(ref_name, ref_seq)]
    paf_lines: List[str] = []

    pool: List[Tuple[int, str, object]] = []  # (pos, kind, payload)
    pool_freq: Optional[np.ndarray] = None
    if site_pool is not None:
        lo = (span[0] if span else 0) + 2
        hi_b = (span[1] if span else ref_len) - 6
        # spacing >= 4 keeps shared indels from overlapping each other
        grid = np.arange(lo, hi_b, 4)
        pos_pool = np.sort(rng.choice(grid, size=min(site_pool, len(grid)),
                                      replace=False))
        for pos in pos_pool:
            pos = int(pos)
            kind = rng.random()
            if kind < p_indel / 2:
                ins = "".join(rng.choice(_BASES, size=int(rng.integers(1, 4))))
                pool.append((pos, "ins", ins))
            elif kind < p_indel:
                pool.append((pos, "del", int(rng.integers(1, 3))))
            else:
                ref_base = ref_seq[pos]
                alt = str(rng.choice([b for b in "ACGT" if b != ref_base]))
                pool.append((pos, "snp", alt))
        # per-site carrier frequency: skewed to rare (pangenome-like SFS)
        pool_freq = rng.beta(0.4, 1.6, size=len(pool))

    for hi in range(n_haps):
        sample = f"HG{900 + hi // 2:05d}"
        hap_no = hi % 2 + 1
        name = f"{sample}#{hap_no}#ctg{hi}"
        if span is None:
            a0 = int(rng.integers(0, max(1, ref_len // 10)))
            a1 = int(rng.integers(ref_len - ref_len // 10, ref_len + 1))
        else:
            a0, a1 = span
        reverse = bool(rng.random() < 0.4)

        snps: Dict[int, str] = {}
        insertions: Dict[int, str] = {}
        deletions: Dict[int, int] = {}
        if site_pool is not None:
            carried = rng.random(len(pool)) < pool_freq
            for (pos, kind, payload), c in zip(pool, carried):
                if not c or pos < a0 + 2 or pos >= a1 - 4:
                    continue
                if kind == "ins":
                    insertions[pos] = payload
                elif kind == "del":
                    deletions[pos] = payload
                else:
                    snps[pos] = payload
        else:
            positions = sorted(
                rng.choice(np.arange(a0 + 2, a1 - 2), size=n_snps,
                           replace=False)
            )
            used: set = set()
            for pos in positions:
                pos = int(pos)
                kind = rng.random()
                if kind < p_indel / 2 and pos not in used:
                    ins = "".join(
                        rng.choice(_BASES, size=int(rng.integers(1, 4))))
                    insertions[pos] = ins
                    used.add(pos)
                elif kind < p_indel and pos + 3 < a1 and not any(
                    p in used for p in range(pos, pos + 3)
                ):
                    dlen = int(rng.integers(1, 3))
                    deletions[pos] = dlen
                    used.update(range(pos, pos + dlen))
                elif pos not in used:
                    ref_base = ref_seq[pos]
                    alt = str(rng.choice([b for b in "ACGT" if b != ref_base]))
                    snps[pos] = alt
                    used.add(pos)

        # build the haplotype sequence + CIGAR from sorted variant segments
        # (O(#variants), not O(ref span) — a base-by-base walk took ~220 s
        # for 2 Mb x 466 haplotypes)
        seq_parts: List[str] = []
        cigar_parts: List[str] = []
        events = sorted(
            [(p, "ins", v) for p, v in insertions.items()]
            + [(p, "del", v) for p, v in deletions.items()]
            + [(p, "snp", v) for p, v in snps.items()]
        )
        prev = a0
        for pos, kind, payload in events:
            if pos < prev:
                continue  # swallowed by a preceding deletion
            if pos > prev:
                seq_parts.append(ref_seq[prev:pos])
                cigar_parts.append(f"{pos - prev}=")
            if kind == "ins":
                seq_parts.append(payload)
                cigar_parts.append(f"{len(payload)}I")
                # the reference base at `pos` follows as part of the next
                # '=' run (insertions sit before the base)
                prev = pos
            elif kind == "del":
                dlen = min(payload, a1 - pos)
                cigar_parts.append(f"{dlen}D")
                prev = pos + dlen
            else:
                seq_parts.append(payload)
                cigar_parts.append("1X")
                prev = pos + 1
        if prev < a1:
            seq_parts.append(ref_seq[prev:a1])
            cigar_parts.append(f"{a1 - prev}=")

        hap_seq = "".join(seq_parts)
        qlen = len(hap_seq)
        stored = _revcomp(hap_seq) if reverse else hap_seq
        fasta_records.append((name, stored))
        cigar = "".join(cigar_parts)
        strand = "-" if reverse else "+"
        # query interval covers the whole stored contig
        paf_lines.append(
            f"{name}\t{qlen}\t0\t{qlen}\t{strand}\t{ref_name}\t{ref_len}\t"
            f"{a0}\t{a1}\t{qlen}\t{qlen}\t60\tcg:Z:{cigar}"
        )
        haps.append(SimHaplotype(name, a0, a1, reverse, snps, insertions,
                                 deletions))

    os.makedirs(out_dir, exist_ok=True)
    fasta_path = os.path.join(out_dir, "pan.fa")

    def wrap60(seq: str) -> bytes:
        # newline insertion via a reshape — the per-60-char python loop
        # dominated genome-scale simulation wall time
        buf = np.frombuffer(seq.encode(), dtype="S1")
        n_full = len(buf) // 60
        parts = []
        if n_full:
            body = np.empty((n_full, 61), dtype="S1")
            body[:, :60] = buf[: n_full * 60].reshape(n_full, 60)
            body[:, 60] = b"\n"
            parts.append(body.tobytes())
        tail = buf[n_full * 60:]
        if tail.size:
            parts.append(tail.tobytes() + b"\n")
        return b"".join(parts)

    with open(fasta_path, "wb") as fh:
        for name, seq in fasta_records:
            fh.write(f">{name}\n".encode())
            fh.write(wrap60(seq))
    paf_path = os.path.join(out_dir, "aln.paf")
    with open(paf_path, "w") as fh:
        fh.write("\n".join(paf_lines) + "\n")
    return SimPangenome(ref_name, ref_seq, haps, fasta_path, paf_path)
