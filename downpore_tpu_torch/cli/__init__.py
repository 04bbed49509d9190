from .main import main

__all__ = ["main"]
