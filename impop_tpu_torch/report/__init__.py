"""Output tables (the port's copy of ``impop_tpu/report/tables.py``); the
trend plots are ``impop_tpu_torch.report.plots``, imported on use."""
from impop_tpu_torch.report.tables import (
    format_pica_output,
    pi_table_header,
    hfst_row,
    HFST_HEADER,
    FST3PI_HEADER,
    TAJD_HEADER,
)

__all__ = [
    "format_pica_output",
    "pi_table_header",
    "hfst_row",
    "HFST_HEADER",
    "FST3PI_HEADER",
    "TAJD_HEADER",
]
