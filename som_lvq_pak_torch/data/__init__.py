from .labels import GLOBAL_LABELS, LABEL_EMPTY, LabelTable
from .dataset import Dataset, Neighborhood, Topology
from .io import read_data, write_data
from .streaming import StreamingReader

__all__ = [
    "GLOBAL_LABELS",
    "LABEL_EMPTY",
    "LabelTable",
    "Dataset",
    "Neighborhood",
    "Topology",
    "read_data",
    "write_data",
    "StreamingReader",
]
