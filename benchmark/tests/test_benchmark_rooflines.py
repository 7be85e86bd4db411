"""Each kernel's count of operations and bytes, by hand at one shape: a
window of 4 rows and 3 sites, panels of 2 and 1 rows in one group each
(their union in two), one pair, scanned twice, and a second window
scanned once."""
import numpy as np
import pytest

from benchmark.spec import load_module
from benchmark.tests.tiny import HERE


class _Truth:
    pairs = [(0, 1)]

    def facts(self, w):
        masks = np.array([[1, 1, 0, 0], [0, 0, 1, 0]], bool)
        return {"geno": np.zeros((4, 3), np.int8), "masks": masks}

    def stats(self, w):
        return {"groups": np.array([1, 1]), "union_groups": np.array([2])}


class _Run:
    truth = _Truth()

    def windows(self):
        yield from [(0, 10), (0, 10), (10, 20)]


def _work(kernel):
    mod = load_module(f"{HERE}/rooflines/{kernel}.py", f"t_{kernel}")
    return mod.work(_Run())


@pytest.mark.parametrize("kernel, ops, nbytes", [
    # identity 3·4·3 = 36 and presence 2·(4 + 1 + 2) = 14 int8; float32
    # 2·(1 + 1 + 4 + (4 + 1 + 2) + 1) = 28 (seeds, union, Hudson's
    # members, seeds a·b); bytes 12 + 1 + 4·10 = 53
    ("window_kernel", {"int8": 150, "fp32": 84}, 159),
    # 3·4·3 pair-sites each; bytes 12 + 12 + 5·16 = 104
    ("weighted_gram", {"int8": 108, "fp32": 108}, 312),
    # rows: grouped 1, 1, 2 (seeds); sides 2, 1 (both kinds): 2·4·7 = 56
    # each; bytes 5·16 + 8·4·(5 + 5) = 400
    ("masked_sums", {"int8": 168, "fp32": 168}, 1200),
    # compares 3·4·3/2 = 18; bytes 12 + 20 = 32
    ("ehh_kernel", {"int8": 54}, 96),
])
def test_counts_by_hand(kernel, ops, nbytes):
    got_ops, got_bytes = _work(kernel)
    assert got_ops == pytest.approx(ops)
    assert got_bytes == pytest.approx(nbytes)


def test_least_time_names_its_bound():
    from benchmark.peaks import least_time

    t, bound = least_time({"fp32": 67e12}, 1.0)
    assert t == pytest.approx(1.0) and bound == "operations (fp32)"
    t, bound = least_time({"int8": 1.0}, 3.35e12)
    assert t == pytest.approx(1.0) and bound == "bytes"
