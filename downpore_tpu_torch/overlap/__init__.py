from .overlapper import Overlapper, SeedQuery, QUERY_EDGES, QUERY_CENTRE, \
    QUERY_ALL, WEIGHT_EDGES
from .combine import SeedContig, build_consensus

__all__ = ["Overlapper", "SeedQuery", "QUERY_EDGES", "QUERY_CENTRE",
           "QUERY_ALL", "WEIGHT_EDGES", "SeedContig", "build_consensus"]
