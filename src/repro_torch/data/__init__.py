"""Synthetic data of the port, deterministic in (seed, step)."""
