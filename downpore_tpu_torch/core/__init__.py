from .sequence import (
    Sequence,
    encode_bases,
    decode_bases,
    reverse_complement,
    rolling_kmers,
    short_kmers,
    count_seed_kmers,
    write_segments,
    kmer_value,
    kmer_string,
    kmer_reverse_complement,
)

__all__ = [
    "Sequence",
    "encode_bases",
    "decode_bases",
    "reverse_complement",
    "rolling_kmers",
    "short_kmers",
    "count_seed_kmers",
    "write_segments",
    "kmer_value",
    "kmer_string",
    "kmer_reverse_complement",
]
