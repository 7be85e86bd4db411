"""Each kernel's count of the operations and bytes its work needs, one file
a kernel: ``KERNELS`` (the device kernel names its launches carry) and
``work(run) -> (operations by type, bytes)`` over every window the traced
window's calls scanned.  Counts follow the semantics at each window's real
shapes (its members, its sites and, for the grouped statistics, its groups
at the threshold, as the plain reference finds them), never a kernel's
design: each input byte read once, each output byte written once, value
products in float32."""
from collections import Counter


def per_window(run):
    """(window, facts, times scanned) of each distinct window of the
    run."""
    counts = Counter(run.windows())
    return [(w, run.truth.facts(w), k) for w, k in counts.items()]


def masks(run, facts):
    """(panel member counts, (a, b) member counts of each pair)."""
    sizes = facts["masks"].sum(axis=1).tolist()
    return sizes, [(sizes[a], sizes[b]) for a, b in run.truth.pairs]


def groups(run, w):
    """(groups of each panel, groups of each pair's union) of window
    ``w`` at the threshold: the grouped statistics' quadratic forms run
    over one seed a group."""
    st = run.truth.stats(w)
    return st["groups"].tolist(), st["union_groups"].tolist()
