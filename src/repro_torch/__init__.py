"""PyTorch + CUDA port of the AutoGNN preprocessing and GNN serve path,
and of the LM substrate's prefill (gemma2-9b).

The JAX package ``repro`` is the reference; this package mirrors its layout
(``core/``, ``kernels/``, ``models/``, ``serve/``, ``configs/``,
``launch/``) so every module has an obvious counterpart. Plain tensor code
is PyTorch; the kernels the reference wrote in Pallas are hand-written CUDA
for Hopper (``csrc/``), each beside a plain-torch twin that runs when the
tensor lies on the CPU.
"""
