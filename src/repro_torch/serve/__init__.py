"""Serving: the slot core, the LM decode engine and the GNN inference
engine."""
from .engine import ServeEngine
from .gnn import GnnServeEngine

__all__ = ["GnnServeEngine", "ServeEngine"]
