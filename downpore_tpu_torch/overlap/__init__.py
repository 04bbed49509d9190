from downpore_tpu.overlap import (QUERY_ALL, QUERY_CENTRE, QUERY_EDGES,
                                  WEIGHT_EDGES, SeedQuery)

from .overlapper import Overlapper

__all__ = ["Overlapper", "SeedQuery", "QUERY_EDGES", "QUERY_CENTRE",
           "QUERY_ALL", "WEIGHT_EDGES"]
