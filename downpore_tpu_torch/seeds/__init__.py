from .seed_sequence import SeedSequence, SeedMatch
from .seed_index import SeedIndex
from .cluster import (match_from, match_to, merge, Cluster,
                      consensus as cluster_consensus)

__all__ = ["SeedSequence", "SeedMatch", "SeedIndex", "match_from",
           "match_to", "merge", "Cluster", "cluster_consensus"]
