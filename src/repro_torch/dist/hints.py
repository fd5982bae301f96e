"""Thread-local layout state and sharding hints (port of
``repro/dist/hints.py``).

Model code calls ``shard_hint(x, *axes)`` on intermediates with logical
axis tokens — ``"dp"`` (data-parallel), ``"model"`` (tensor or expert
parallel), a mesh axis name, or None — and this module resolves them
against the active layout. Every rank holds its own shard as a plain
tensor (explicit SPMD), so on a plain tensor a hint is an exact identity;
on a ``DTensor`` it redistributes to the placements the tokens resolve
to. With no mesh active, or hints suspended, every hint is the identity.

Layouts map tokens to mesh axes:

* ``"tp"`` (default) — ``dp`` → every mesh axis but ``model``; ``model``
  → the ``model`` axis.
* ``"dp_only"`` — ``dp`` → ``("data", "model")`` (the batch covers both
  axes, parameters stay whole); ``model`` → ``pod`` when the mesh has
  one, else nothing.

Torch has no ambient ``with mesh:``: the only source of a mesh is
``layout(mesh)``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading

from .sharding import _axes_size as _mesh_axes_size
from .sharding import axis_names, placements

_DEFAULT_LAYOUT = "tp"

_state = threading.local()


@dataclasses.dataclass(frozen=True)
class _Layout:
    name: str
    mesh: object | None


def _stack() -> list:
    if not hasattr(_state, "stack"):
        _state.stack = []
    return _state.stack


def _current_mesh():
    for entry in reversed(_stack()):
        if entry.mesh is not None:
            return entry.mesh
    return None


def current_layout() -> str:
    st = _stack()
    return st[-1].name if st else _DEFAULT_LAYOUT


@contextlib.contextmanager
def layout(mesh_or_name=_DEFAULT_LAYOUT, name: str | None = None):
    """Activate a layout: ``layout(mesh)``, ``layout("dp_only")`` (the
    enclosing mesh stays) or ``layout(mesh, "dp_only")``. Nestable;
    restores the previous layout and mesh on exit."""
    if isinstance(mesh_or_name, str):
        entry = _Layout(mesh_or_name, None)
    else:
        entry = _Layout(name or _DEFAULT_LAYOUT, mesh_or_name)
    st = _stack()
    st.append(entry)
    try:
        yield entry
    finally:
        st.pop()


@contextlib.contextmanager
def suspend_hints():
    """Make every ``shard_hint`` inside the block an identity."""
    _state.suspend = getattr(_state, "suspend", 0) + 1
    try:
        yield
    finally:
        _state.suspend -= 1


def _axis_map(mesh, layout_name: str) -> dict:
    names = axis_names(mesh)
    if layout_name == "dp_only":
        return {"dp": tuple(a for a in names if a in ("data", "model")),
                "model": "pod" if "pod" in names else None}
    return {"dp": tuple(a for a in names if a != "model"),
            "model": "model" if "model" in names else None}


def _axes_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return _mesh_axes_size(mesh, axes)


def mesh_info() -> tuple[tuple[str, ...], int]:
    """(dp axis names, model-axis size) of the active layout; with no
    mesh active ``(("data",), 1)``."""
    mesh = _current_mesh()
    if mesh is None:
        return ("data",), 1
    amap = _axis_map(mesh, current_layout())
    return amap["dp"], _axes_size(mesh, amap["model"])


def hint_spec(mesh, shape, axes) -> tuple | None:
    """The ``PartitionSpec`` entries the tokens ``axes`` resolve to for a
    tensor of ``shape`` under the active layout, or None where no token
    resolves to an axis above 1 (or the ranks differ). A token that does
    not divide its dim, or reuses an axis, is dropped."""
    if len(shape) != len(axes):
        return None
    amap = _axis_map(mesh, current_layout())
    mesh_names = set(axis_names(mesh))
    used: set[str] = set()
    spec = []
    for dim, tok in zip(shape, axes):
        resolved = None
        if tok is not None:
            if tok in amap:
                resolved = amap[tok]
            elif tok in mesh_names:
                resolved = tok
        if resolved is not None:
            flat = (resolved,) if isinstance(resolved, str) else \
                tuple(resolved)
            size = _axes_size(mesh, flat)
            if (not flat or size <= 1 or dim % size
                    or used.intersection(flat)):
                resolved = None
            else:
                used.update(flat)
        spec.append(resolved)
    if all(s is None for s in spec):
        return None
    return tuple(spec)


def shard_hint(x, *axes):
    """Constrain ``x`` (one token a dim) under the active layout: the
    identity on a plain tensor, with no mesh, with hints suspended, or
    where no token resolves; a ``DTensor`` is redistributed to the
    resolved placements."""
    if getattr(_state, "suspend", 0):
        return x
    mesh = _current_mesh()
    if mesh is None:
        return x
    shape = getattr(x, "shape", None)
    if shape is None:
        return x
    spec = hint_spec(mesh, tuple(shape), axes)
    if spec is None:
        return x
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:  # pragma: no cover - older torch
        from torch.distributed._tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, placements(mesh, spec))
