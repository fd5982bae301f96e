"""Preprocessing primitives of the port: containers, cost model,
Ordering, Reshaping, Selecting, Reindexing and the pipeline.

``convert_xla``, ``preprocess_xla_baseline`` and ``edge_ordering_xla`` are
the paper's GPU baseline (library sorts and ``searchsorted`` only, no
hand-written kernel); ``searchsorted_oracle`` is the tests' oracle for the
compare-reduce paths."""
from .graph import COO, CSC, SENTINEL, Subgraph, next_pow2, pad_to, random_coo
from .set_count import (count_equal, count_less_than, filter_lookup,
                        rank_in_sorted, rank_in_sorted2, searchsorted_oracle)
from .ordering import (DEFAULT_CHUNK, edge_ordering, edge_ordering_xla,
                       stable_sort_by_key, supports_packed_keys)
from .pipeline import (apply_delta, convert, convert_xla, gather_features,
                       preprocess, preprocess_xla_baseline, sample_subgraph)
from .costmodel import EngineConfig, MERGE_CFG, SLICE_CFG, Workload

__all__ = [k for k in dir() if not k.startswith("_")]
