"""Adapter trimming on the torch engine, and the bundled ONT adapter set
(``downpore_tpu_torch.data``)."""
from ..data import BACK_ADAPTERS, FRONT_ADAPTERS

from .trimmer import Trimmer, load_trimmer

__all__ = ["Trimmer", "load_trimmer", "FRONT_ADAPTERS", "BACK_ADAPTERS"]
