"""The host-only commands of the port: copies of ``impop_tpu/cli.py``
lines 2307-2376 (``spectrum``), 2382-2643 (``extract`` with its VCF
writer, ``gfasim``, ``gfa2vcf``, ``import-agc``, ``merge-parts``,
``makewindows``, ``plot``) and 2888-2975 (their parsers), with the port's
own ``io``, ``extract`` and ``report`` in place of the JAX package's.

None of them touches a device: each writes the files its JAX original
writes from the same inputs (``tests/test_torch_hostcmds.py``).
matplotlib is imported only when a command draws (``spectrum`` without
``--no-plots``, ``plot``).  :func:`add_parsers` registers them on the
port's command line (``impop_tpu_torch.cli``).
"""
from __future__ import annotations

import os
import sys
from typing import Dict, List

import numpy as np

from impop_tpu_torch.hostio import (_open_extractor, _out_stream,
                                    _resolve_fasta, _sanitize, _warn,
                                    read_bed, read_panel_file)
from impop_tpu_torch.io.bed import Region, make_windows

__all__ = ["add_parsers", "cmd_spectrum", "cmd_extract", "cmd_gfasim",
           "cmd_gfa2vcf", "cmd_import_agc", "cmd_merge_parts",
           "cmd_makewindows", "cmd_plot"]


# --------------------------------------------------------------- spectrum


def cmd_spectrum(args) -> int:
    """Allele-frequency spectrum from a site-by-haplotype table (the
    capability of wip/op-afs.py): per polymorphic site, allele counts and
    frequencies, plus histogram panels saved as PNGs.

    The input is a TSV with a header whose columns from ``--first-site-col``
    onward are sites; rows are haplotypes.  By default every allele at a
    site contributes; ``--compat-first-allele`` records only the first
    allele met per site, as the reference script does.
    """
    rows = []
    with open(args.input) as fh:
        header = fh.readline().rstrip("\n").split("\t")
        for line in fh:
            parts = line.rstrip("\n").split("\t")
            if len(parts) == len(header):
                rows.append(parts)
    site_cols = list(range(args.first_site_col, len(header)))
    counts_by_allele: Dict[str, List[int]] = {}
    freqs_by_allele: Dict[str, List[float]] = {}
    table_rows = []
    for c in site_cols:
        values = [r[c] for r in rows]
        if not values or all(v == values[0] for v in values):
            continue  # monomorphic sites are skipped
        total = len(values)
        tally: Dict[str, int] = {}
        for v in values:
            tally[v] = tally.get(v, 0) + 1
        items = list(tally.items())
        if args.compat_first_allele:
            items = items[:1]
        for allele, count in items:
            freq = count / total
            counts_by_allele.setdefault(allele, []).append(count)
            freqs_by_allele.setdefault(allele, []).append(freq)
            table_rows.append((header[c], allele, count, freq))

    out = _out_stream(args.output)
    try:
        print("site\tallele\tcount\tfrequency", file=out)
        for site, allele, count, freq in table_rows:
            print(f"{site}\t{allele}\t{count}\t{freq:.6f}", file=out)
    finally:
        if out is not sys.stdout:
            out.close()

    if not args.no_plots and counts_by_allele:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        for data, path, label in (
            (counts_by_allele, args.counts_png, "counts"),
            (freqs_by_allele, args.freqs_png, "frequencies"),
        ):
            fig, axes = plt.subplots(len(data), 1,
                                     figsize=(8, 4 * len(data)), squeeze=False)
            for ax, (allele, vec) in zip(axes[:, 0], sorted(data.items())):
                ax.hist(vec, bins="auto")
                ax.set_title(f"allele {allele}")
                ax.set_xlabel(label)
                ax.set_ylabel("sites")
            fig.tight_layout()
            fig.savefig(path, dpi=120)
            plt.close(fig)
            _warn(f"wrote {path}")
    return 0


# --------------------------------------------------------------- extract


def _write_window_vcf(path, chrom: str, wm) -> None:
    """Window variants as minimal VCF (the consumable of ``povu gfa2vcf
    --stdout``): one record per variant key, so the non-header line count
    is the segregating-site count S, with per-haplotype GT columns (0 ref /
    1 alt / . uncovered).  ``path`` is a file name or an open stream."""
    import contextlib

    ctx = (open(path, "w") if isinstance(path, str)
           else contextlib.nullcontext(path))
    with ctx as fh:
        fh.write("##fileformat=VCFv4.2\n")
        fh.write("##source=impop-tpu extract\n")
        cols = "\t".join(n.replace("\t", "_") for n in wm.names)
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                 + cols + "\n")
        for c, key in enumerate(wm.site_keys):
            pos_s, rest = key.split(":", 1)
            ref, alt = rest.split(">", 1)
            ref_out = ref if ref else "N"
            alt_out = alt if alt else "<DEL>"
            gts = []
            for row in range(len(wm.names)):
                val = wm.geno[row, c]
                gts.append("." if val < 0 else str(int(val)))
            fh.write(
                f"{chrom}\t{int(pos_s) + 1}\t.\t{ref_out}\t{alt_out}\t.\t"
                f".\tNS={sum(g != '.' for g in gts)}\tGT\t" + "\t".join(gts)
                + "\n"
            )


def cmd_extract(args) -> int:
    """PAF + FASTA -> per-window allele tiles (.npz), optionally with
    per-window VCFs and variation-graph GFAs."""
    from impop_tpu_torch.extract import split_window_matrix

    regions = read_bed(args.bed)
    os.makedirs(args.out_dir, exist_ok=True)
    fasta_store = _resolve_fasta(args)
    if not fasta_store:
        raise SystemExit("error: provide --fasta or --agc")
    extractor = _open_extractor(args.paf, fasta_store,
                                use_native=not args.python)
    if args.split:
        # one CIGAR walk per BED row, then a column slice per window
        expanded = []
        for reg in regions:
            rs = reg.region_string(args.prefix)
            try:
                wm_range = extractor.extract(rs.rsplit(":", 1)[0],
                                             reg.start, reg.end)
            except Exception as e:
                _warn(f"Warning: extraction failed for {rs}: {e}")
                continue
            wins = make_windows(reg.chrom, reg.start, reg.end, args.split)
            parts = split_window_matrix(
                wm_range, [(w.start, w.end) for w in wins]
            )
            expanded.extend(zip(wins, parts))
        window_iter = expanded
    else:
        window_iter = None
    n_ok = n_err = 0
    for item in (window_iter if window_iter is not None else regions):
        if window_iter is not None:
            reg, wm = item
            rs = reg.region_string(args.prefix)
        else:
            reg = item
            rs = reg.region_string(args.prefix)
            try:
                wm = extractor.extract(
                    rs.rsplit(":", 1)[0], reg.start, reg.end
                )
            except Exception as e:
                _warn(f"Warning: extraction failed for {rs}: {e}")
                n_err += 1
                continue
        out = os.path.join(args.out_dir, f"{_sanitize(rs)}.npz")
        np.savez_compressed(
            out,
            geno=wm.geno,
            names=np.asarray(wm.names),
            site_pos=np.asarray(wm.site_pos),
            site_keys=np.asarray(wm.site_keys),
        )
        if args.vcf:
            _write_window_vcf(
                os.path.join(args.out_dir, f"{_sanitize(rs)}.vcf"),
                rs.rsplit(":", 1)[0], wm,
            )
        if args.gfa:
            from impop_tpu_torch.extract.gfa import window_to_gfa
            from impop_tpu_torch.extract.pyfallback import fetch_fasta_window

            target = rs.rsplit(":", 1)[0]
            ref_seq = fetch_fasta_window(fasta_store, target, reg.start,
                                         reg.end)
            with open(os.path.join(args.out_dir,
                                   f"{_sanitize(rs)}.gfa"), "w") as fh:
                fh.write(window_to_gfa(wm, ref_seq, reg.start, target))
        n_ok += 1
    _warn(f"extracted {n_ok} windows ({n_err} failed) -> {args.out_dir}")
    return 0 if n_ok or not n_err else 1


def cmd_gfasim(args) -> int:
    """Variation-graph path similarity (the ``odgi similarity``
    capability): a TSV of length-weighted overlap metrics for every path
    pair, with the ``group.a/group.b/estimated.identity`` columns that
    ``pi --sim-dir`` reads."""
    from impop_tpu_torch.extract.gfa import read_gfa, similarity_from_gfa

    header, rows = similarity_from_gfa(read_gfa(args.gfa))
    fh = _out_stream(args.output)
    fh.write("\t".join(header) + "\n")
    for row in rows:
        fh.write("\t".join(row) + "\n")
    if args.output:
        fh.close()
    return 0


def cmd_gfa2vcf(args) -> int:
    """Variation graph -> VCF (the ``povu gfa2vcf --stdout <ref>``
    capability): bubbles against the reference path become VCF records."""
    from impop_tpu_torch.extract.gfa import alleles_from_gfa, read_gfa

    wm, ref_name = alleles_from_gfa(read_gfa(args.gfa), ref_path=args.ref)
    chrom = ref_name.rsplit(":", 1)[0] if ":" in ref_name else ref_name
    _write_window_vcf(args.output or sys.stdout, chrom, wm)
    if args.npz:
        np.savez_compressed(args.npz, geno=wm.geno,
                            names=np.asarray(wm.names),
                            site_pos=np.asarray(wm.site_pos),
                            site_keys=np.asarray(wm.site_keys))
    return 0


# --------------------------------------------------------------- utilities


def cmd_import_agc(args) -> int:
    """AGC archive -> random-access BGZF FASTA store
    (``extract/agc.py``): convert once, then every command reads the store
    natively."""
    from impop_tpu_torch.extract.agc import convert_agc, list_samples

    if args.list:
        for name in list_samples(args.archive, args.agc_bin):
            print(name)
        return 0
    samples = read_panel_file(args.samples) if args.samples else None
    out = args.output or (args.archive + ".impop.fa.gz")
    convert_agc(args.archive, out, samples=samples, agc_bin=args.agc_bin,
                prefix_sample=args.prefix_sample)
    if args.verify:
        if args.prefix_sample:
            raise SystemExit("error: --verify compares original record "
                             "names; rerun without --prefix-sample")
        from impop_tpu_torch.extract.agc import verify_store

        n_checked = verify_store(args.archive, out, agc_bin=args.agc_bin,
                                 samples=samples)
        _warn(f"verified {n_checked} sequences against the archive "
              "(md5 round-trip)")
    if args.index:
        # build the .fai/.gzi indexes now (otherwise on first use)
        try:
            from impop_tpu_torch.extract import load_library

            lib = load_library()
            # opening an empty PAF indexes the FASTA store
            empty_paf = out + ".noalign.paf"
            with open(empty_paf, "w"):
                pass
            h = lib.ix_open(empty_paf.encode(), out.encode())
            err = lib.ix_error(h)
            lib.ix_close(h)
            os.remove(empty_paf)
            if err:
                raise RuntimeError(err.decode())
        except Exception as e:
            _warn(f"Warning: indexing deferred to first use ({e})")
    _warn(f"wrote {out}")
    return 0


def cmd_merge_parts(args) -> int:
    """Merge the ``<file>.partK`` outputs of a distributed scan into one
    file: tables concatenate in part order; spectra (``--sum``) add their
    counts per allele-count bin."""
    import glob as _glob

    base = args.output
    parts = sorted(
        _glob.glob(f"{base}.part*"),
        key=lambda p: int(p.rsplit("part", 1)[1]),
    )
    if not parts:
        raise SystemExit(f"error: no {base}.part* files found")
    if args.sum:
        totals: Dict[int, List[int]] = {}
        header = None
        for path in parts:
            with open(path) as fh:
                header = fh.readline().rstrip("\n")
                for line in fh:
                    cells = line.rstrip("\n").split("\t")
                    k = int(cells[0])
                    vals = [int(x) for x in cells[1:]]
                    if k in totals:
                        totals[k] = [a + b for a, b in zip(totals[k], vals)]
                    else:
                        totals[k] = vals
        with open(base, "w") as out:
            out.write((header or "") + "\n")
            for k in sorted(totals):
                out.write(f"{k}\t" + "\t".join(map(str, totals[k])) + "\n")
    else:
        with open(base, "w") as out:
            for idx, path in enumerate(parts):
                with open(path) as fh:
                    header = fh.readline()
                    if idx == 0:
                        out.write(header)
                    for line in fh:
                        out.write(line)
    if args.remove:
        for path in parts:
            os.remove(path)
    _warn(f"merged {len(parts)} parts -> {base}")
    return 0


def cmd_makewindows(args) -> int:
    out = _out_stream(args.output)
    try:
        if args.bed:
            base = read_bed(args.bed)
        else:
            chrom, start, end = args.region.split(args.sep)
            base = [Region(chrom, int(start), int(end))]
        for reg in base:
            for win in make_windows(reg.chrom, reg.start, reg.end,
                                    args.window):
                print(f"{win.chrom}\t{win.start}\t{win.end}", file=out)
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def cmd_plot(args) -> int:
    from impop_tpu_torch.report.plots import plot_trend

    return plot_trend(args)


# --------------------------------------------------------------- parsers


def add_parsers(sub) -> None:
    """The parsers of the commands above, with the JAX package's flags."""
    p = sub.add_parser("spectrum",
                       help="allele-frequency spectrum from a "
                            "site-by-haplotype table (op-afs)")
    p.add_argument("--input", required=True)
    p.add_argument("--first-site-col", type=int, default=3,
                   help="0-based index of the first site column (default 3)")
    p.add_argument("-o", "--output")
    p.add_argument("--counts-png", default="counts.png")
    p.add_argument("--freqs-png", default="freqs.png")
    p.add_argument("--no-plots", action="store_true")
    p.add_argument("--compat-first-allele", action="store_true",
                   help="record only the first allele per site "
                        "(op-afs.py:40-44 behaviour)")
    p.set_defaults(func=cmd_spectrum)

    p = sub.add_parser("extract",
                       help="PAF+FASTA -> per-window allele tiles (.npz)")
    p.add_argument("-b", "--bed", required=True)
    p.add_argument("--paf", required=True)
    p.add_argument("--fasta")
    p.add_argument("--agc", help="AGC archive (one-time cached conversion)")
    p.add_argument("--agc-bin", default="agc")
    p.add_argument("--out-dir", required=True)
    p.add_argument("-P", "--prefix", default="CHM13#0#")
    p.add_argument("--python", action="store_true",
                   help="force the Python fallback extractor")
    p.add_argument("--vcf", action="store_true",
                   help="also write per-window VCFs (povu gfa2vcf "
                        "capability; non-header line count == S)")
    p.add_argument("--gfa", action="store_true",
                   help="also write per-window variation-graph GFAs "
                        "(impg query -o gfa capability)")
    p.add_argument("--split", type=int, default=None,
                   help="extract each BED row once and split into windows "
                        "of this many bp (one CIGAR walk per row)")
    p.set_defaults(func=cmd_extract)

    p = sub.add_parser("gfasim",
                       help="path similarity TSV from a variation graph "
                            "(odgi similarity capability)")
    p.add_argument("gfa", help="GFA v1/v1.1 file")
    p.add_argument("-o", "--output", help="output TSV (default: stdout)")
    p.set_defaults(func=cmd_gfasim)

    p = sub.add_parser("gfa2vcf",
                       help="variants vs reference path from a variation "
                            "graph (povu gfa2vcf capability)")
    p.add_argument("gfa", help="GFA v1/v1.1 file")
    p.add_argument("--ref", help="reference path name (default: "
                                 "CHM13-prefixed or coordinate-named path)")
    p.add_argument("-o", "--output", help="output VCF (default: stdout)")
    p.add_argument("--npz", help="also write the allele tile as .npz")
    p.set_defaults(func=cmd_gfa2vcf)

    p = sub.add_parser("merge-parts",
                       help="merge <file>.partK outputs of a distributed "
                            "scan into one file")
    p.add_argument("output", help="base output path (parts are "
                                  "<output>.part0, .part1, ...)")
    p.add_argument("--sum", action="store_true",
                   help="numeric merge for AFS spectra (sum counts per "
                        "allele-count bin) instead of row concatenation")
    p.add_argument("--remove", action="store_true",
                   help="delete the part files after merging")
    p.set_defaults(func=cmd_merge_parts)

    p = sub.add_parser("import-agc",
                       help="AGC archive -> random-access BGZF FASTA store")
    p.add_argument("archive", help="input .agc archive")
    p.add_argument("-o", "--output",
                   help="output store (default: <archive>.impop.fa.gz)")
    p.add_argument("--samples", help="panel list file: convert only these "
                                     "assemblies")
    p.add_argument("--prefix-sample", action="store_true",
                   help="prefix contig names with '<sample>#' (for archives "
                        "whose contig names collide across assemblies)")
    p.add_argument("--agc-bin", default="agc")
    p.add_argument("--list", action="store_true",
                   help="list assemblies in the archive and exit")
    p.add_argument("--index", action="store_true",
                   help="build the .fai/.gzi indexes immediately")
    p.add_argument("--verify", action="store_true",
                   help="after converting, stream every sample back out of "
                        "the archive and md5-compare each sequence against "
                        "the store (checksum round-trip)")
    p.set_defaults(func=cmd_import_agc)

    p = sub.add_parser("makewindows", help="fixed-width windows from a region")
    p.add_argument("--bed", help="BED of base intervals")
    p.add_argument("--region", help="chrom<sep>start<sep>end string")
    p.add_argument("--sep", default=":")
    p.add_argument("-w", "--window", type=int, required=True)
    p.add_argument("-o", "--output")
    p.set_defaults(func=cmd_makewindows)

    p = sub.add_parser("plot", help="trend plots from result tables")
    p.add_argument("kind", choices=["pi", "fst", "tajd"])
    p.add_argument("--input", action="append", default=[],
                   help="[LABEL=]table.tsv (repeatable)")
    p.add_argument("--input-dir", help="plot every file in a directory")
    p.add_argument("--output", default=None)
    p.add_argument("--title", default=None)
    p.add_argument("--dpi", type=int, default=150)
    p.add_argument("--highlight", action="append", default=[],
                   help="chrom:start-end intervals to shade (repeatable)")
    p.add_argument("--highlight-bed")
    p.add_argument("--linear-y", action="store_true",
                   help="linear y axis for pi (default: log10)")
    p.set_defaults(func=cmd_plot)
