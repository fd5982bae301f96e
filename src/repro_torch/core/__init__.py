"""Preprocessing primitives of the port: containers, cost model,
Ordering, Reshaping, Selecting, Reindexing and the pipeline."""
