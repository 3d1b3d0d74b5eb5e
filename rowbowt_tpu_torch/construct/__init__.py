from rowbowt_tpu_torch.construct.panel import Marker, Panel, build_panel, parse_fasta, parse_vcf
from rowbowt_tpu_torch.construct.sa import suffix_array
from rowbowt_tpu_torch.construct.build import build_index

__all__ = [
    "Marker",
    "Panel",
    "build_panel",
    "parse_fasta",
    "parse_vcf",
    "suffix_array",
    "build_index",
]
