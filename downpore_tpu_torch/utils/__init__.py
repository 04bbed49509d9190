from .kmers import (kmer_occurrences, long_kmer_occurrences,
                    top_occurrences, default_kmer_values,
                    load_kmer_values, load_confusion_matrix,
                    score_seed_values)
from .metrics import StageTimer, start_profiler, stop_profiler

__all__ = ["kmer_occurrences", "long_kmer_occurrences", "top_occurrences",
           "default_kmer_values", "load_kmer_values",
           "load_confusion_matrix", "score_seed_values", "StageTimer",
           "start_profiler", "stop_profiler"]
