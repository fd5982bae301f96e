"""The census of one call: what a path issued, op by op (the counterpart
of ``repro/launch/hlo_analysis.py`` and ``repro/launch/hlo_inspect.py``).

Those two modules read XLA's HLO text: the compiled program's opcodes,
its ``while`` loops with their trip counts, its dot FLOPs and its
collective bytes. A torch program has no such text; this module stands
in for them by watching the call as it runs. ``census()`` is a context
manager whose ``TorchDispatchMode`` sees every aten op the thread issues
and records:

* the ops issued outside any kernel scope, by name (``aten::sort``,
  ``aten::scatter_``; an ``index_put_`` that accumulates is named
  ``aten::index_put_[accumulate]``): the path's own program;
* the kernel wrappers' calls and the launches each declares
  (``kernels.kernel_scope``), on the CPU as on the card, and the ops
  issued inside a scope, by wrapper (a twin's, or a wrapper's own
  allocations);
* the FLOPs of ``mm`` / ``bmm`` / ``addmm`` / ``baddbmm``, from their
  shapes, wherever they run;
* each collective of ``dist/groups.py`` (and the rank-by-rank gather of
  ``engine/shard.py``): its kind and operand bytes, as the reference
  counts an all-gather's operand;
* on the card, the change in ``kernels.launch_counts()`` over the call,
  which must equal the declared launches (an empty change where launches
  were declared is a wrapper that took its twin); on the CPU no reading
  (None).

A census never runs inside a CUDA-graph capture (it raises there): a
captured step is checked through ``captured_launches()`` against one
eager step's census instead.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.dist.groups import set_collective_recorder
from repro_torch.kernels import (current_kernel_scope, launch_counts,
                                 set_scope_recorder)

_MATMULS = {"aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm"}
_INDEX_PUTS = {"aten::index_put", "aten::index_put_",
               "aten::_index_put_impl_"}
# the native sorts (argsort and msort reach the mode as aten::sort, listed
# all the same)
SORT_OPS = ("aten::sort", "aten::argsort", "aten::msort")


@dataclasses.dataclass
class Census:
    ops: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    scoped_ops: dict = dataclasses.field(default_factory=dict)
    calls: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    launches: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    flops: float = 0.0
    collectives: list = dataclasses.field(default_factory=list)
    # the launch counters' change over a call on the card; None on the CPU
    # (no kernel launches there) and until the call ends
    launch_delta: dict | None = None

    @property
    def sort_count(self) -> int:
        """Native sorts issued outside the kernel scopes."""
        return sum(self.ops[name] for name in SORT_OPS)

    @property
    def collective_bytes(self) -> float:
        return float(sum(b for _, b in self.collectives))

    def hits(self, pattern: str) -> dict[str, int]:
        """The ops outside the scopes whose name contains ``pattern``."""
        return {k: n for k, n in self.ops.items() if pattern in k}

    def to_json(self) -> dict:
        return {"ops": dict(self.ops), "calls": dict(self.calls),
                "launches": dict(self.launches), "flops": self.flops,
                "collective_bytes": self.collective_bytes,
                "launch_delta": self.launch_delta,
                "scoped_ops": {k: dict(v) for k, v in
                               self.scoped_ops.items()}}


def _shape(t) -> tuple:
    return tuple(t.shape) if isinstance(t, torch.Tensor) else ()


def matmul_flops(name: str, args) -> float:
    """2 · m · k · n (· batch) of one matmul op, from its operand shapes."""
    if name in ("aten::mm", "aten::bmm"):
        a, b = _shape(args[0]), _shape(args[1])
    else:  # addmm / baddbmm: (bias, a, b)
        a, b = _shape(args[1]), _shape(args[2])
    if len(a) < 2 or len(b) < 2:
        return 0.0
    return 2.0 * math.prod(a) * b[-1]


def op_name(func, args, kwargs) -> str:
    """The schema name of an aten op; an accumulating index write is
    marked, since it is the float-atomic kind on the card."""
    name = func._schema.name
    if name in _INDEX_PUTS:
        acc = kwargs.get("accumulate", args[3] if len(args) > 3 else False)
        if acc:
            return f"{name}[accumulate]"
    return name


class _Mode(TorchDispatchMode):
    def __init__(self, census: Census):
        super().__init__()
        self.census = census

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = op_name(func, args, kwargs)
        scope = current_kernel_scope()
        c = self.census
        if scope is None:
            c.ops[name] += 1
        else:
            c.scoped_ops.setdefault(scope, collections.Counter())[name] += 1
        if name in _MATMULS:
            c.flops += matmul_flops(name, args)
        return func(*args, **kwargs)


@contextlib.contextmanager
def census(device=None):
    """Record the census of what runs inside the ``with`` block on this
    thread; ``device`` (default: the card when there is one) is where the
    call runs. On the card the launch counters' change is read into
    ``launch_delta``; on the CPU no kernel launches, and it stays None."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("a census never runs inside a CUDA-graph capture")
    c = Census()

    def on_scope(name, launches):
        c.calls[name] += 1
        if launches:
            c.launches[name] += launches

    def on_collective(kind, nbytes):
        c.collectives.append((kind, nbytes))

    on_card = (torch.device(device).type == "cuda" if device is not None
               else torch.cuda.is_available())
    before = launch_counts()
    old_scope = set_scope_recorder(on_scope)
    old_coll = set_collective_recorder(on_collective)
    try:
        with _Mode(c):
            yield c
    finally:
        set_scope_recorder(old_scope)
        set_collective_recorder(old_coll)
        if on_card:
            torch.cuda.synchronize()
            after = launch_counts()
            c.launch_delta = {k: after[k] - before[k] for k in after
                              if after[k] != before[k]}
