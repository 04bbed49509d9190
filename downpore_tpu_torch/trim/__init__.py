"""Adapter trimming on the torch engine, and the bundled ONT adapter set
(``downpore_tpu.data``, JAX-free host data) re-exported so that callers of
the port import from ``downpore_tpu_torch`` alone."""
from downpore_tpu.data import BACK_ADAPTERS, FRONT_ADAPTERS

from .trimmer import Trimmer, load_trimmer

__all__ = ["Trimmer", "load_trimmer", "FRONT_ADAPTERS", "BACK_ADAPTERS"]
