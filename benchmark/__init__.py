"""The benchmark of ``impop_tpu_torch`` (see ``benchmark/run.py``)."""
