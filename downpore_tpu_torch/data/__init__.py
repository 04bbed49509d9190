from .adapters import FRONT_ADAPTERS, BACK_ADAPTERS
