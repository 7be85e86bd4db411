"""The reference's own plot_*_trend.R scripts read the port's tables (the
twin of ``tests/test_plots.py``): the tables are written by the port's
``report/tables`` row formatters, the code the port's commands emit
through.  Under the same guard as the original: the tests run wherever
``Rscript`` is installed and skip elsewhere."""
from __future__ import annotations

from test_plots import _run_r, _windows, needs_r

from impop_tpu_torch.report.tables import (HFST_HEADER, TAJD_HEADER,
                                           format_pica_output, hfst_row,
                                           pi_row, pi_table_header, tajd_row)


@needs_r
def test_plot_pi_trend_reads_our_table(tmp_path):
    table = tmp_path / "eur.pi"
    with open(table, "w") as fh:
        fh.write(pi_table_header(with_subset=True) + "\n")
        for i, (c, s, e) in enumerate(_windows()):
            out = format_pica_output(0.0012, 3.1e-6 * (i + 1), e - s)
            fh.write(pi_row(f"CHM13#0#{c}:{s}-{e}", "EUR", e - s,
                            0.999, 5, out) + "\n")
    png = tmp_path / "pi.png"
    _run_r("plot_pi_trend.R",
           ["--input", f"EUR={table}", "--output", str(png)], tmp_path)
    assert png.exists() and png.stat().st_size > 0


@needs_r
def test_plot_fst_trend_reads_our_table(tmp_path):
    table = tmp_path / "eur.afr.fst"
    with open(table, "w") as fh:
        fh.write(HFST_HEADER + "\n")
        for i, (c, s, e) in enumerate(_windows()):
            fh.write(hfst_row(f"CHM13#0#{c}:{s}-{e}", e - s,
                              0.19 + 0.01 * i, 2.8e-6, 5.8e-6, 4.3e-6,
                              5.3e-6, 1.0e-6) + "\n")
    png = tmp_path / "fst.png"
    _run_r("plot_fst_trend.R",
           ["--input", f"EURvAFR={table}", "--output", str(png)], tmp_path)
    assert png.exists() and png.stat().st_size > 0


@needs_r
def test_plot_tajd_trend_reads_our_table(tmp_path):
    table = tmp_path / "eur.tj"
    with open(table, "w") as fh:
        fh.write(TAJD_HEADER + "\n")
        for i, (c, s, e) in enumerate(_windows()):
            d = float("nan") if i == 3 else -1.99 + 0.2 * i
            fh.write(tajd_row(f"CHM13#0#{c}:{s}-{e}", e - s, 446, 20,
                              5.9e-6, d) + "\n")
    png = tmp_path / "tajd.png"
    _run_r("plot_tajd_trend.R",
           ["--input", f"EUR={table}", "--output", str(png)], tmp_path)
    assert png.exists() and png.stat().st_size > 0
