"""Host k-mer helpers the port shares with ``downpore_tpu.utils.kmers``
(host path: no mesh, no JAX), re-exported so that callers of the port
import from ``downpore_tpu_torch`` alone, and the commands' stage timer
and ``torch.profiler`` hooks (``metrics``)."""
from downpore_tpu.utils.kmers import kmer_occurrences, score_seed_values

from .metrics import StageTimer, start_profiler, stop_profiler

__all__ = ["kmer_occurrences", "score_seed_values", "StageTimer",
           "start_profiler", "stop_profiler"]
