"""Host sequence types the port shares with ``downpore_tpu.core`` (a
JAX-free host module), re-exported so that callers of the port import
from ``downpore_tpu_torch`` alone."""
from downpore_tpu.core import Sequence

__all__ = ["Sequence"]
