"""Host k-mer helpers the port shares with ``downpore_tpu.utils.kmers``
(host path: no mesh, no JAX), re-exported so that callers of the port
import from ``downpore_tpu_torch`` alone."""
from downpore_tpu.utils.kmers import kmer_occurrences, score_seed_values

__all__ = ["kmer_occurrences", "score_seed_values"]
