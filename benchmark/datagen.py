"""The benchmark's synthetic pangenome, made from a seed.

A vectorised rewrite of the port's ``extract/simulate.py`` in its shared
site-pool mode: a random reference and a pool of variant sites on a grid of
spacing 4 (so that no two indels overlap), each a SNP, an insertion of 1-3
bases or a deletion of 1-2 bases.  Every assembly covers the whole region.

Who carries a site follows a genealogy, so that haplotypes share structure
as real ones do.  The region is cut into segments, each with one coalescent
tree over every assembly and the reference: the panels are demes that
split from one ancestral population (isolation, no migration), and the
population grew exponentially (which skews the spectrum to rare alleles).
Each pool site falls on a branch of its segment's tree with a probability
proportional to the branch's length; the assemblies that differ from the
reference below or above that branch carry it.

:func:`make_pangenome` returns the record (:class:`Pangenome`) that the
plain reference reads; :func:`write_paf_fasta` and :func:`write_tiles` write
the program's inputs from it: a FASTA of every haplotype with a PAF of their
alignments to the reference (``cg:Z:`` CIGARs, 40% on the reverse strand),
or one compressed ``.npz`` allele tile per window in the format the port's
``extract`` command writes.
"""
from __future__ import annotations

import concurrent.futures as futures
import dataclasses
import os
import zipfile
from typing import Dict, List, Sequence, Tuple

import numpy as np

__all__ = ["Pangenome", "make_pangenome", "write_paf_fasta", "write_tiles",
           "window_sites", "row_names", "panel_masks"]

SNP, INS, DEL = 0, 1, 2


def rng_for(seed: int, stream: int = 0) -> np.random.Generator:
    """The generator of one use (``stream``) of ``seed``; any whole
    number, negative ones too."""
    return np.random.default_rng([int(seed) % (1 << 63), stream])
_ACGT = np.frombuffer(b"ACGT", np.uint8)


@dataclasses.dataclass
class Pangenome:
    chrom: str                 # BED chromosome ("chr1")
    ref_name: str              # the reference's sequence name
    ref: np.ndarray            # [L] uint8 base codes 0-3
    pos: np.ndarray            # [K] int64 pool site positions (ascending)
    kind: np.ndarray           # [K] int8 SNP / INS / DEL
    alt: np.ndarray            # [K] uint8 SNP alt base code
    del_len: np.ndarray        # [K] int64 deleted bases (DEL)
    ins_off: np.ndarray        # [K] int64 offset of the inserted bases
    ins_len: np.ndarray        # [K] int64 inserted bases (INS)
    ins_bases: np.ndarray      # [sum ins_len] uint8 base codes
    carriers: np.ndarray       # [H, K] bool: assembly h carries site k
    stems: List[str]           # [H] assembly sequence names
    reverse: np.ndarray        # [H] bool: stored reverse-complemented
    panels: Dict[str, List[int]]   # panel -> assembly indices
    panel_entries: Dict[str, List[str]]  # panel -> panel-file lines
    tokens: List[str]          # [K] CIGAR operation of each pool site

    @property
    def length(self) -> int:
        return int(self.ref.shape[0])


def _pick_pairs(rng: np.random.Generator, k: np.ndarray):
    """Two distinct slots below ``k`` (one count a tree)."""
    a = np.floor(rng.random(k.shape) * k).astype(np.int64)
    b = np.floor(rng.random(k.shape) * (k - 1)).astype(np.int64)
    return a, b + (b >= a)


def _genealogies(rng: np.random.Generator, n_trees: int,
                 demes: List[List[int]], n: int, growth: float,
                 split: float) -> Tuple[np.ndarray, np.ndarray]:
    """``n_trees`` coalescent trees over leaves ``0..n-1``: (clade bitsets
    [T, 2n-1, words] uint64, branch lengths [T, 2n-1]; the root's is 0).

    Each deme's lineages coalesce among themselves (Kingman: any two of k
    at rate k(k-1)/2) until the standard time ``split``; the lineages left
    then coalesce as one population.  Standard time tau becomes real time
    log(1 + growth·tau) / growth: a population that grew exponentially."""
    nodes = 2 * n - 1
    leaf = np.arange(n)
    clade = np.zeros((n_trees, nodes, (n + 63) // 64), np.uint64)
    clade[:, leaf, leaf // 64] = np.left_shift(
        np.uint64(1), (leaf % 64).astype(np.uint64))
    born = np.zeros((n_trees, nodes))
    parent = np.full((n_trees, nodes), -1, np.int64)
    nxt = np.full(n_trees, n, np.int64)
    trees = np.arange(n_trees)

    def merge(sel, slots, k, when):
        t = trees[sel]
        a, b = _pick_pairs(rng, k)
        x, y, node = slots[t, a], slots[t, b], nxt[sel]
        clade[t, node] = clade[t, x] | clade[t, y]
        born[t, node] = when
        parent[t, x] = parent[t, y] = node
        nxt[sel] += 1
        slots[t, a] = node
        slots[t, b] = slots[t, k - 1]

    pool = np.full((n_trees, n), -1, np.int64)
    count = np.zeros(n_trees, np.int64)
    for members in demes:
        m = len(members)
        slots = np.tile(np.asarray(members, np.int64), (n_trees, 1))
        left = np.full(n_trees, m)
        if m > 1:
            k_of = np.arange(m, 1, -1)
            at = np.cumsum(rng.exponential(size=(n_trees, m - 1))
                           / (k_of * (k_of - 1) / 2.0), axis=1)
            for j in range(m - 1):
                sel = at[:, j] < split
                if not sel.any():
                    break
                merge(sel, slots, np.full(int(sel.sum()), m - j), at[sel, j])
            left = m - (at < split).sum(axis=1)
        for t in range(n_trees):
            pool[t, count[t]:count[t] + left[t]] = slots[t, :left[t]]
        count += left
    now = np.full(n_trees, float(split))
    while (count > 1).any():
        sel = count > 1
        k = count[sel]
        now[sel] += rng.exponential(size=k.size) / (k * (k - 1) / 2.0)
        merge(sel, pool, k, now[sel])
        count[sel] -= 1
    real = np.log1p(growth * born) / growth if growth > 0 else born
    above = np.take_along_axis(real, np.maximum(parent, 0), axis=1)
    return clade, np.where(parent >= 0, above - real, 0.0)


def _carriers(rng: np.random.Generator, gen: dict, pos: np.ndarray,
              length: int, demes: List[List[int]], n: int) -> np.ndarray:
    """[n - 1, K] bool: leaf 1 + i (assembly i) differs from leaf 0 (the
    reference) at pool site k.  ``gen``: ``segment_bp`` (the region holds
    ``length // segment_bp`` segments, their bounds uniform), ``growth``
    and ``split`` (:func:`_genealogies`)."""
    n_trees = max(1, length // int(gen["segment_bp"]))
    bounds = np.sort(rng.integers(1, length, size=n_trees - 1))
    tree_of = np.searchsorted(bounds, pos, side="right")
    out = np.empty((n - 1, pos.size), bool)
    for lo in range(0, n_trees, 256):
        hi = min(n_trees, lo + 256)
        clade, blen = _genealogies(rng, hi - lo, demes, n,
                                   float(gen["growth"]), float(gen["split"]))
        cum = np.cumsum(blen, axis=1)
        for t in range(lo, hi):
            sites = np.nonzero(tree_of == t)[0]
            if not sites.size:
                continue
            c = cum[t - lo]
            node = np.minimum(np.searchsorted(
                c, rng.random(sites.size) * c[-1], side="right"),
                c.size - 1)
            bits = np.unpackbits(clade[t - lo, node].view(np.uint8), axis=1,
                                 bitorder="little")[:, :n].astype(bool)
            bits ^= bits[:, :1]          # relative to the reference
            out[:, sites] = bits[:, 1:].T
    return out


def make_pangenome(cfg: dict, seed: int) -> Pangenome:
    """The record of one configuration's pangenome for ``seed``.

    ``cfg["data"]`` gives ``region_bp``, ``site_every_bp``, ``p_indel``,
    ``genealogy`` (:func:`_carriers`) and the assemblies: ``panels`` (name -> haplotypes,
    two per sample), ``other_samples`` (diploid samples in no panel) and
    ``haploid`` (single-haplotype assemblies in no panel).  The reference
    itself is a further row of every window (the extractor adds it)."""
    d = cfg["data"]
    rng = rng_for(seed)
    length = int(d["region_bp"])
    ref = rng.integers(0, 4, size=length, dtype=np.uint8)
    n_sites = length // int(d["site_every_bp"])
    grid = np.arange(2, length - 6, 4)
    pos = np.sort(rng.choice(grid, size=min(n_sites, grid.size),
                             replace=False)).astype(np.int64)
    k = pos.size
    p_indel = float(d["p_indel"])
    u = rng.random(k)
    kind = np.where(u < p_indel / 2, INS,
                    np.where(u < p_indel, DEL, SNP)).astype(np.int8)
    alt = ((ref[pos] + rng.integers(1, 4, size=k)) % 4).astype(np.uint8)
    del_len = np.where(kind == DEL, rng.integers(1, 3, size=k), 0)
    ins_len = np.where(kind == INS, rng.integers(1, 4, size=k), 0)
    ins_off = np.concatenate([[0], np.cumsum(ins_len)[:-1]]).astype(np.int64)
    ins_bases = rng.integers(0, 4, size=int(ins_len.sum()), dtype=np.uint8)
    # assemblies: panel samples in a seeded order of sample ids, then the
    # samples and haploid assemblies outside every panel
    n_panel_samples = sum(int(v) // 2 for v in d["panels"].values())
    n_samples = n_panel_samples + int(d["other_samples"])
    ids = [f"HG{1 + i:05d}" for i in range(n_samples)]
    order = rng.permutation(n_samples)
    stems: List[str] = []
    panels: Dict[str, List[int]] = {}
    entries: Dict[str, List[str]] = {}
    at = 0
    for name, haps in d["panels"].items():
        panels[name], entries[name] = [], []
        for si in order[at:at + int(haps) // 2]:
            for hap in (1, 2):
                panels[name].append(len(stems))
                stems.append(f"{ids[si]}#{hap}#{cfg['chrom']}")
                entries[name].append(f"{ids[si]}_hap{hap}_hprc_r2_v1.0.1")
        at += int(haps) // 2
    for si in order[at:]:
        for hap in (1, 2):
            stems.append(f"{ids[si]}#{hap}#{cfg['chrom']}")
    for name in d["haploid"]:
        stems.append(f"{name}#0#{cfg['chrom']}")
    h = len(stems)
    # leaf 0 of every tree is the reference, leaf 1 + i assembly i; each
    # panel is a deme, the assemblies in no panel and the reference one more
    demes = [[1 + i for i in panels[name]] for name in panels]
    inside = {i for name in panels for i in panels[name]}
    demes.append([0] + [1 + i for i in range(h) if i not in inside])
    carriers = _carriers(rng, d["genealogy"], pos, length, demes, h + 1)
    reverse = rng.random(h) < 0.4
    tokens = [("1X", f"{n}I", f"{d}D")[t] for t, n, d in zip(
        kind.tolist(), ins_len.tolist(), del_len.tolist())]
    return Pangenome(cfg["chrom"], cfg["ref_name"], ref, pos, kind, alt,
                     del_len.astype(np.int64), ins_off,
                     ins_len.astype(np.int64), ins_bases, carriers, stems,
                     reverse, panels, entries, tokens)


def _ragged(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """concat(arange(s, s + n) for s, n)."""
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    rep = np.repeat(starts - np.concatenate([[0], np.cumsum(lens)[:-1]]),
                    lens)
    return rep + np.arange(total)


def _haplotype(pg: Pangenome, h: int) -> Tuple[np.ndarray, str]:
    """(forward sequence codes, CIGAR against the reference) of
    assembly ``h``."""
    c = pg.carriers[h]
    seq = pg.ref.copy()
    snp = c & (pg.kind == SNP)
    seq[pg.pos[snp]] = pg.alt[snp]
    dels = c & (pg.kind == DEL)
    gone = _ragged(pg.pos[dels], pg.del_len[dels])
    keep = np.ones(seq.size, bool)
    keep[gone] = False
    seq = seq[keep]
    ins = c & (pg.kind == INS)
    at = pg.pos[ins] - np.searchsorted(gone, pg.pos[ins])
    bases = pg.ins_bases[_ragged(pg.ins_off[ins], pg.ins_len[ins])]
    seq = np.insert(seq, np.repeat(at, pg.ins_len[ins]), bases)

    sel = np.nonzero(c)[0]
    p = pg.pos[sel]
    kd = pg.kind[sel]
    consumed = np.where(kd == SNP, 1, np.where(kd == DEL, pg.del_len[sel], 0))
    ends = p + consumed
    gaps = p - np.concatenate([[0], ends[:-1]])
    tok = pg.tokens
    tail = pg.length - (int(ends[-1]) if ends.size else 0)
    cigar = "".join(map("{}={}".format, gaps.tolist(),
                        [tok[i] for i in sel.tolist()]))
    cigar += f"{tail}=" if tail else ""
    return seq, cigar


def _wrap60(codes: np.ndarray) -> bytes:
    buf = _ACGT[codes]
    n_full = buf.size // 60
    body = np.empty((n_full, 61), np.uint8)
    body[:, :60] = buf[:n_full * 60].reshape(n_full, 60)
    body[:, 60] = ord("\n")
    tail = buf[n_full * 60:]
    return body.tobytes() + (tail.tobytes() + b"\n" if tail.size else b"")


def write_panels(pg: Pangenome, out_dir: str) -> List[str]:
    """One ``agc.<PANEL>`` file per panel (assembly names, one a line);
    returns their paths."""
    paths = []
    for name, lines in pg.panel_entries.items():
        path = os.path.join(out_dir, f"agc.{name}")
        with open(path, "w") as fh:
            fh.write("\n".join(lines) + "\n")
        paths.append(path)
    return paths


def write_paf_fasta(pg: Pangenome, out_dir: str) -> Tuple[str, str]:
    """(paf path, fasta path): the reference and every haplotype in one
    FASTA (60 bases a line), one full-length alignment each in the PAF."""
    os.makedirs(out_dir, exist_ok=True)
    fasta = os.path.join(out_dir, "pan.fa")
    paf = os.path.join(out_dir, "aln.paf")

    def record(h):
        seq, cigar = _haplotype(pg, h)
        # codes 0-3 are A, C, G, T: the complement of c is 3 - c
        stored = 3 - seq[::-1] if pg.reverse[h] else seq
        q = seq.size
        strand = "-" if pg.reverse[h] else "+"
        return (f">{pg.stems[h]}\n".encode() + _wrap60(stored),
                f"{pg.stems[h]}\t{q}\t0\t{q}\t{strand}\t{pg.ref_name}\t"
                f"{pg.length}\t0\t{pg.length}\t{q}\t{q}\t60\tcg:Z:{cigar}")

    lines = []
    with open(fasta, "wb") as fh, \
            futures.ThreadPoolExecutor(max_workers=4) as pool:
        fh.write(f">{pg.ref_name}\n".encode() + _wrap60(pg.ref))
        for lo in range(0, len(pg.stems), 32):
            for rec, line in pool.map(record,
                                      range(lo, min(lo + 32, len(pg.stems)))):
                fh.write(rec)
                lines.append(line)
    with open(paf, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return paf, fasta


def window_sites(pg: Pangenome, start: int, end: int):
    """The columns the extractor gives window [start, end): (pool site
    index [s], column position [s], key strings [s]), sorted as the
    extractor sorts its (pos, ref, alt) variants, keeping only sites that
    some assembly carries.  SNPs and deletions belong to the window their
    first base in it falls in (a deletion is clipped to the window);
    insertions, which sit before the base at their position, to the window
    with start < pos <= end."""
    lo = np.searchsorted(pg.pos, start - 2)
    hi = np.searchsorted(pg.pos, end, side="right")
    idx = np.arange(lo, hi)
    p, kd, dl = pg.pos[idx], pg.kind[idx], pg.del_len[idx]
    col = np.maximum(p, start)
    ok = np.where(kd == INS, (p > start) & (p <= end),
                  np.where(kd == DEL, (p + dl > start) & (p < end),
                           (p >= start) & (p < end)))
    ok &= pg.carriers[:, idx].any(axis=0)
    idx, col = idx[ok], col[ok]
    keys = []
    for i, cp in zip(idx.tolist(), col.tolist()):
        k = pg.kind[i]
        if k == SNP:
            ref, alt = chr(_ACGT[pg.ref[cp]]), chr(_ACGT[pg.alt[i]])
        elif k == INS:
            o, n = pg.ins_off[i], pg.ins_len[i]
            ref, alt = "", _ACGT[pg.ins_bases[o:o + n]].tobytes().decode()
        else:
            stop = min(int(pg.pos[i] + pg.del_len[i]), end)
            ref, alt = _ACGT[pg.ref[cp:stop]].tobytes().decode(), ""
        keys.append((cp, ref, alt))
    order = sorted(range(len(keys)), key=lambda j: keys[j])
    idx = idx[order]
    col = np.asarray([keys[j][0] for j in order], np.int64)
    skeys = [f"{keys[j][0]}:{keys[j][1]}>{keys[j][2]}" for j in order]
    return idx, col, skeys


def row_names(pg: Pangenome, start: int, end: int
              ) -> Tuple[List[str], np.ndarray]:
    """(sorted row names, assembly index of each row, -1 for the
    reference's own row) of window [start, end): ``<sequence>:<start>-<end>``.
    Sequence names are distinct and none is a prefix of another, so the
    extractor's rows (``<contig>:<qstart>-<qend>``) sort the same way."""
    names = [f"{pg.ref_name}:{start}-{end}"]
    names += [f"{s}:{start}-{end}" for s in pg.stems]
    order = sorted(range(len(names)), key=lambda j: names[j])
    return [names[j] for j in order], np.asarray(order, np.int64) - 1


def panel_masks(pg: Pangenome, rows: np.ndarray) -> np.ndarray:
    """[P, N] bool: row r is a member of panel p (panels in sorted name
    order, as the scan orders its ``--panel`` files)."""
    masks = np.zeros((len(pg.panels), rows.size), bool)
    for pi, name in enumerate(sorted(pg.panels)):
        members = np.zeros(len(pg.stems) + 1, bool)
        members[np.asarray(pg.panels[name]) + 1] = True
        masks[pi] = members[rows + 1]
    return masks


def window_geno(pg: Pangenome, rows: np.ndarray, idx: np.ndarray
                ) -> np.ndarray:
    """[N, s] int8 allele matrix of the rows (assembly indices, -1 the
    reference) at pool sites ``idx``: 1 carried, 0 not."""
    g = np.zeros((rows.size, idx.size), np.int8)
    real = rows >= 0
    g[real] = pg.carriers[np.ix_(rows[real], idx)]
    return g


def _save_npz(path: str, **arrays) -> None:
    """``np.savez_compressed`` at deflate level 1."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED,
                         compresslevel=1) as zf:
        for name, arr in arrays.items():
            with zf.open(f"{name}.npy", "w") as fh:
                np.lib.format.write_array(fh, np.asanyarray(arr),
                                          allow_pickle=False)


def write_tiles(pg: Pangenome, windows: Sequence[Tuple[int, int]],
                out_dir: str) -> None:
    """One ``<ref>:<start>-<end>.npz`` per window with ``geno`` [n, s] int8,
    ``names`` [n], ``site_pos`` [s] and ``site_keys`` [s], rows sorted by
    name, as the port's ``extract`` command writes them."""
    os.makedirs(out_dir, exist_ok=True)

    def one(window):
        start, end = window
        idx, col, keys = window_sites(pg, start, end)
        names, rows = row_names(pg, start, end)
        _save_npz(os.path.join(out_dir, f"{pg.ref_name}:{start}-{end}.npz"),
                  geno=window_geno(pg, rows, idx), names=np.asarray(names),
                  site_pos=col, site_keys=np.asarray(keys, dtype=str))

    with futures.ThreadPoolExecutor(max_workers=4) as pool:
        list(pool.map(one, windows))
