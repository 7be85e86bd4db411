"""The port's sanitized extraction smoke: the twin of the sanitizer stages
of the repository's ``ci.sh``.

    python -m impop_tpu_torch.bench.ci_extract [--sanitize address thread]

Builds the native extractor's ``address`` and ``thread`` variants
(``impop_tpu_torch.extract.library_path(sanitize)``: ``cpp/*.cc`` with
``-fsanitize=... -g -O1`` into ``impop_tpu_torch/_build/`` under their own
names; the production library is neither rebuilt nor replaced, and nothing
is written into ``cpp/``), then runs ``bench/extract_smoke.py`` once per
variant in a child process with the sanitizer's runtime first in
``LD_PRELOAD`` (``gcc -print-file-name=libasan.so`` / ``libtsan.so``),
``halt_on_error=1`` (ASan also ``detect_leaks=0``) and four extraction
threads (``IMPOP_EXTRACT_THREADS=4``, as in ``ci.sh``), so the threaded
range walk, padded fill and wire pack run under the sanitizer.  Exits
non-zero when a build fails, a child fails or a sanitizer reports.
Imports no torch.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

from impop_tpu_torch.extract import SANITIZERS, library_path

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_RUNTIME = {"address": "libasan.so", "thread": "libtsan.so"}
_OPTIONS = {"address": ("ASAN_OPTIONS", "detect_leaks=0:halt_on_error=1"),
            "thread": ("TSAN_OPTIONS", "halt_on_error=1")}
THREADS = 4
TIMEOUT_S = 600           # each sanitized smoke
# a sanitizer's report, whatever it found
_REPORT = ("ERROR: AddressSanitizer", "WARNING: ThreadSanitizer",
           "ERROR: ThreadSanitizer")


def runtime_path(kind: str) -> str:
    """The sanitizer's runtime library as gcc names it; raises when gcc
    does not have it."""
    name = _RUNTIME[kind]
    path = subprocess.run(["gcc", f"-print-file-name={name}"],
                          capture_output=True, text=True,
                          check=True).stdout.strip()
    if not os.path.isabs(path) or not os.path.exists(path):
        raise RuntimeError(f"gcc has no {name} (got {path!r})")
    return path


def child_env(kind: str) -> dict:
    """The smoke's environment: the runtime first in LD_PRELOAD, the
    sanitizer's options, the worker count and the repository on the
    path."""
    env = dict(os.environ)
    env["LD_PRELOAD"] = " ".join(
        [runtime_path(kind)] + ([env["LD_PRELOAD"]]
                                if env.get("LD_PRELOAD") else []))
    key, value = _OPTIONS[kind]
    env[key] = value
    env["IMPOP_EXTRACT_THREADS"] = str(THREADS)
    env["PYTHONPATH"] = REPO + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    return env


def run_smoke(kind: str) -> tuple:
    """(ok, seconds, output) of one sanitized smoke."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "impop_tpu_torch.bench.extract_smoke",
         "--threads", str(THREADS), "--sanitize", kind],
        env=child_env(kind), cwd=REPO, capture_output=True, text=True,
        timeout=TIMEOUT_S)
    out = proc.stdout + proc.stderr
    ok = (proc.returncode == 0 and "extract_smoke OK" in proc.stdout
          and not any(r in out for r in _REPORT))
    return ok, time.perf_counter() - t0, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m impop_tpu_torch.bench.ci_extract")
    ap.add_argument("--sanitize", nargs="+", choices=sorted(SANITIZERS),
                    default=["address", "thread"])
    args = ap.parse_args(argv)
    failed = []
    for kind in args.sanitize:
        t0 = time.perf_counter()
        lib = library_path(kind)
        print(f"== {kind}: {os.path.basename(lib)} ready in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        ok, secs, out = run_smoke(kind)
        tail = "\n".join(out.strip().splitlines()[-40:])
        print(f"== {kind} extraction smoke "
              f"({'OK' if ok else 'FAILED'}, {secs:.1f} s):\n{tail}",
              flush=True)
        if not ok:
            failed.append(kind)
    if failed:
        print(f"ci_extract: FAILED under {', '.join(failed)}",
              file=sys.stderr)
        return 1
    print("ci_extract OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
