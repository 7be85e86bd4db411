"""The port's sanitized extraction smoke (``python -m
impop_tpu_torch.bench.ci_extract``, the twin of ``ci.sh``'s sanitizer
stages): each instrumented variant of the native extractor is built under
its own name and leaves the production library as it was (same path,
same mtime), and the smoke runs clean under ASan and TSan in a child
process with the runtime preloaded, loading the instrumented library.

No test here loads an instrumented library into the pytest process: it
needs the sanitizer's runtime first in the process."""
from __future__ import annotations

import os
import subprocess
import sys

import pytest

from impop_tpu_torch import extract

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("kind", sorted(extract.SANITIZERS))
def test_variant_builds_beside_the_production_library(kind, tmp_path,
                                                      monkeypatch):
    """In a build directory of its own (so that no other test's build
    touches it): the variant is built under its own name beside a
    production library that stays as it was, and nothing of it lands in
    cpp/ (where the JAX package's make builds)."""
    monkeypatch.setattr(extract, "_BUILD_DIR", str(tmp_path))
    prod = extract._lib_target()
    with open(prod, "wb") as fh:
        fh.write(b"production")
    before = os.stat(prod).st_mtime_ns
    path = extract.library_path(kind)
    assert os.path.basename(path).startswith(f"libimpop_extract-{kind}-")
    assert os.path.dirname(path) == str(tmp_path) and path != prod
    assert os.path.getsize(path) > 100_000
    assert extract.library_path() == prod
    assert os.stat(prod).st_mtime_ns == before
    with open(prod, "rb") as fh:
        assert fh.read() == b"production"
    assert sorted(os.listdir(tmp_path)) == sorted(
        os.path.basename(p) for p in (prod, path))
    assert not any(kind in name
                   for name in os.listdir(os.path.join(REPO, "cpp")))


def test_unknown_sanitizer_is_refused():
    with pytest.raises(ValueError, match="unknown sanitizer"):
        extract.library_path("memory")


@pytest.mark.parametrize("kind", sorted(extract.SANITIZERS))
def test_sanitized_smoke_through_the_runner(kind):
    """The runner's child loads the instrumented library under its
    preloaded runtime, runs the threaded entry points with 4 workers and
    ends without a report."""
    proc = subprocess.run(
        [sys.executable, "-m", "impop_tpu_torch.bench.ci_extract",
         "--sanitize", kind],
        cwd=REPO, capture_output=True, text=True, timeout=400)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out
    assert "ci_extract OK" in proc.stdout, out
    assert f"library libimpop_extract-{kind}-" in proc.stdout, out
    assert "threads=4" in proc.stdout, out
