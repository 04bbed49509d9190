from .seqio import SequenceSet

__all__ = ["SequenceSet"]
