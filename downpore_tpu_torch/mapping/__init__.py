from .mapper import Mapper, Mapping

__all__ = ["Mapper", "Mapping"]
