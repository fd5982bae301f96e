"""Serving: the slot core and the GNN inference engine."""
from .gnn import GnnServeEngine

__all__ = ["GnnServeEngine"]
