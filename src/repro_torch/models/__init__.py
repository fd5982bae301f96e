"""Models of the port (GraphSAGE)."""
