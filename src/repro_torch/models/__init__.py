"""Models of the port (GraphSAGE; the gemma2-style LM transformer)."""
