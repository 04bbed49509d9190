from .measures import (SimpleMeasure, EditDistanceMeasure, MatrixMeasure,
                       make_measure)
from .band import update_offsets_np, MAX_COST
from .dtw import DTWAligner

__all__ = ["SimpleMeasure", "EditDistanceMeasure", "MatrixMeasure",
           "make_measure", "update_offsets_np", "MAX_COST", "DTWAligner"]
