"""The read-set type the port shares with ``downpore_tpu.io`` (a JAX-free
host module), re-exported so that callers of the port import from
``downpore_tpu_torch`` alone."""
from downpore_tpu.io import SequenceSet

__all__ = ["SequenceSet"]
