"""``python -m impop_tpu_torch.bench``: the port's benchmark
(:mod:`impop_tpu_torch.bench.main`)."""
import sys

from impop_tpu_torch.bench.main import main

if __name__ == "__main__":
    sys.exit(main())
