"""BED, panel and similarity-TSV input (the port's copies of
``impop_tpu/io/*.py``)."""
from impop_tpu_torch.io.simtsv import read_similarity_tsv, SimilarityMatrix, round_half_even
from impop_tpu_torch.io.panels import canonicalize_identifier, expand_population, read_panel_file
from impop_tpu_torch.io.bed import read_bed, make_windows, Region

__all__ = [
    "read_similarity_tsv",
    "SimilarityMatrix",
    "round_half_even",
    "canonicalize_identifier",
    "expand_population",
    "read_panel_file",
    "read_bed",
    "make_windows",
    "Region",
]
