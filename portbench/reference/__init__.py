"""Plain PyTorch references of what the benchmark measures.

Nothing here imports the program (``repro_torch``), the JAX package or JAX:
these are frozen, independent copies of the semantics the program has to
meet, written with plain ``torch`` operations only:

* ``graph``: the seeded graph, feature and weight generator;
* ``prng``: the threefry-2x32 key schedule and uniform draws;
* ``convert``: COO -> CSC by one library sort;
* ``sampler``: Floyd k-hop sampling, first-occurrence reindexing and the
  subgraph's CSC;
* ``models``: a model kind's forward, found by name in ``model_<kind>``
  (``model_graphsage``, ``model_gatedgcn``), in float32 or with the matmul
  operands rounded to TF32 (the control).
"""
