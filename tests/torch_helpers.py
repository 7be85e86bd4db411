"""Inputs shared by the port's scan tests."""


def partial_pangenome(out_dir: str):
    """A simulated 6 kb pangenome whose assemblies each cover part of the
    reference, so windows at both ends lose rows, with two crafted
    queries beside them: ``HG00909#1#dup``, aligned twice over 2,000-3,000
    (one stem, two rows), and ``ACHM13#0#chr1``, aligned over 500-1,000 and
    1,000-1,500 from the same query coordinates, so that each of its rows'
    names holds its window's reference-row name (``CHM13#0#chr1:500-1000``)."""
    from impop_tpu_torch.extract.simulate import simulate

    sim = simulate(out_dir, ref_len=6000, n_haps=10, seed=5, site_pool=40)
    ref = sim.ref_seq
    # query -> (sequence, records as (query start, query end, target start))
    extra = {
        "ACHM13#0#chr1": (ref[:1500], [(500, 1000, 500), (1000, 1500, 1000)]),
        "HG00909#1#dup": (ref[2000:3000] * 2,
                          [(0, 1000, 2000), (1000, 2000, 2000)]),
    }
    with open(sim.fasta_path, "a") as fa, open(sim.paf_path, "a") as paf:
        for name, (seq, records) in extra.items():
            fa.write(f">{name}\n" + "".join(
                seq[i:i + 60] + "\n" for i in range(0, len(seq), 60)))
            for qs, qe, ts in records:
                n = qe - qs
                paf.write(f"{name}\t{len(seq)}\t{qs}\t{qe}\t+\t"
                          f"{sim.ref_name}\t{len(ref)}\t{ts}\t{ts + n}\t"
                          f"{n}\t{n}\t60\tcg:Z:{n}=\n")
    return sim
