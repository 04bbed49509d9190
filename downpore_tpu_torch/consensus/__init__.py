from .consensus import build_consensus, build_consensus_bulk

__all__ = ["build_consensus", "build_consensus_bulk"]
