"""Device: the card's busy time inside the scan step's enqueue per batch,
in ms, from the trace: the union of the card's kernels, copies and fills
that falls inside the ``stage:device`` marks (one a batch: the host
queueing ``scanstep.scan_step`` and the rows' copy), over the marks.
Work a step leaves queued past its mark is not counted; None where the
card did nothing in the window (a CPU run)."""


def _union(iv):
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    steps = _union([(a, b) for n, a, b in t.marks if n == "stage:device"])
    if not steps:
        return None
    busy = _union([(a, b) for _, a, b in t.device])
    inside, i = 0.0, 0
    for a, b in steps:          # both sorted and disjoint: one sweep
        while i < len(busy) and busy[i][1] <= a:
            i += 1
        j = i
        while j < len(busy) and busy[j][0] < b:
            inside += min(b, busy[j][1]) - max(a, busy[j][0])
            j += 1
    return 1e-3 * inside / len(steps)
