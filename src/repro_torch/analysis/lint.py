"""AST lint pass: repo-specific rules over ``src/repro_torch`` (port of
``repro/analysis/lint.py``).

Each rule encodes a bug class of the reference's catalog that exists in
torch code too, restated for it. Pure AST and the standard library: it
runs where nothing can be built or launched.

Suppressions are explicit and must carry a reason, in the reference's
syntax::

    seen[v] = len(order)  # repro: allow-scatter-write — a host dict

A suppression comment on the violation line, or on a contiguous comment
block immediately above it, silences the rule; a marker without a reason
(or naming no rule) is itself a violation (``bare-suppression``).
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re


@dataclasses.dataclass(frozen=True)
class Rule:
    """One lint rule: what it flags and the bug class it guards."""

    rule_id: str
    summary: str
    history: str


RULES = {r.rule_id: r for r in [
    Rule("raw-jit",
         "a CUDA-graph capture (torch.cuda.graph, CUDAGraph) outside "
         "serve/slots.py, or ctypes.CDLL outside kernels/_build.py",
         "The reference's class: a program built per call or per instance "
         "instead of once in its owner (a jax.jit an engine). Here a "
         "capture outside the slot core skips its binding check, its "
         "launch accounting (captured_launches) and its refusal beside a "
         "prefetch producer; a library loaded outside _build.load skips "
         "the source hash, the build cache and the ctypes signatures."),
    Rule("scatter-write",
         "a scatter-family write (scatter*, index_put*, index_add*, "
         "index_copy*, put_, or an assignment through a computed index) "
         "in a convert-spine module",
         "The reference's class: a relocation written as a scatter "
         "serializes (and on the card a float scatter-add is an atomic, "
         "which breaks batched == sequential); every spine relocation is "
         "a gather by the inverse permutation (set_partition, the merge's "
         "inverse-rank router)."),
    Rule("traced-if",
         "a host sync of a device value (.item(), .tolist(), .cpu(), "
         ".numpy(), bool(...), an if/while on a torch expression) in a "
         "spine module or a captured step's body",
         "The reference's traced-value branch: under jit it raised or "
         "constant-folded; here it stalls the host on the card, and inside "
         "a CUDA-graph capture it fails (the capture runs under "
         "set_sync_debug_mode('error')). The strategy dispatch stays on "
         "static metadata."),
    Rule("host-numpy-in-jit",
         "a host numpy call in a spine module or a captured step's body "
         "(dtype / iinfo-style metadata allowed)",
         "The reference's class: np.* runs on the host at trace time and "
         "pins what should be device inputs; here it also reads device "
         "values back through the host, and a captured step replays "
         "without it."),
    Rule("mutable-default",
         "mutable literal ([]/{}/set) as a parameter default",
         "One list shared across every call — in serve/'s threaded request "
         "path that is cross-request state leakage (request state lives "
         "in Request / slot objects instead)."),
    Rule("bare-suppression",
         "a '# repro: allow-<rule>' marker with no reason text",
         "Suppressions document why the rule does not apply at that site; "
         "a bare marker is indistinguishable from silencing noise."),
]}

# Modules where the relocation spine lives (the reference's list).
SPINE_MODULES = (
    "core/ordering.py", "core/set_partition.py", "core/set_count.py",
    "core/reshaping.py", "core/reindexing.py", "core/pipeline.py",
    "engine/shard.py",
)
# Functions whose bodies are captured into a CUDA graph on the card (the
# serve step programs and the slot function they run), by module.
CAPTURED_BODIES = {
    "serve/gnn.py": ("build_step", "build_slot_fn"),
    "serve/engine.py": ("build_step",),
}
CAPTURE_OWNER = "serve/slots.py"
LIBRARY_OWNER = "kernels/_build.py"

_SCATTER_METHODS = {"scatter", "scatter_", "scatter_add", "scatter_add_",
                    "scatter_reduce", "scatter_reduce_", "index_put",
                    "index_put_", "index_add", "index_add_", "index_copy",
                    "index_copy_", "put_", "put", "masked_scatter",
                    "masked_scatter_"}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
# numpy attributes that are metadata, not host compute
_NP_META = {
    "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
    "uint64", "float16", "float32", "float64", "bool_", "dtype",
    "iinfo", "finfo", "ndarray", "generic",
}

_ALLOW_RE = re.compile(r"#\s*repro:\s*allow-([\w-]+)[ \t]*[—:–-]?[ \t]*(.*)")


@dataclasses.dataclass(frozen=True)
class LintViolation:
    path: str  # tree-relative
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def _suppressions(src: str) -> dict[int, tuple[str, bool]]:
    """line number → (rule id, has_reason) for every allow marker."""
    out: dict[int, tuple[str, bool]] = {}
    for i, line in enumerate(src.splitlines(), start=1):
        m = _ALLOW_RE.search(line)
        if m:
            out[i] = (m.group(1), len(m.group(2).strip()) >= 3)
    return out


class _Aliases:
    """Import-derived names of torch, numpy and ctypes."""

    def __init__(self) -> None:
        self.torch: set[str] = set()
        self.np: set[str] = set()
        self.ctypes: set[str] = set()
        self.direct: dict[str, str] = {}  # local name -> "CUDAGraph" ...

    def collect(self, tree: ast.AST) -> None:
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    name = a.asname or a.name.split(".")[0]
                    top = a.name.split(".")[0]
                    if top == "torch":
                        self.torch.add(name)
                    elif a.name == "numpy":
                        self.np.add(name)
                    elif a.name == "ctypes":
                        self.ctypes.add(name)
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    if a.name in ("CUDAGraph", "graph", "CDLL"):
                        self.direct[a.asname or a.name] = a.name

    def _chain(self, node: ast.AST) -> list[str]:
        parts = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if isinstance(node, ast.Name):
            parts.append(node.id)
            return parts[::-1]
        return []

    def capture_or_library(self, func: ast.AST) -> str | None:
        """"capture" / "library" when ``func`` is a CUDA-graph capture or
        a ctypes library load."""
        chain = self._chain(func)
        if not chain:
            return None
        if len(chain) == 1:
            kind = self.direct.get(chain[0])
            return {"CUDAGraph": "capture", "graph": "capture",
                    "CDLL": "library"}.get(kind)
        if chain[0] in self.torch and chain[-2:] in (["cuda", "graph"],
                                                     ["cuda", "CUDAGraph"]):
            return "capture"
        if chain[0] in self.ctypes and chain[-1] in ("CDLL", "LoadLibrary"):
            return "library"
        return None

    def is_torch_call(self, node: ast.AST) -> bool:
        return (isinstance(node, ast.Call)
                and (self._chain(node.func)[:1] or [None])[0] in self.torch)


def _is_scatter_call(node: ast.Call) -> bool:
    f = node.func
    return isinstance(f, ast.Attribute) and f.attr in _SCATTER_METHODS


def _computed_index(target: ast.AST) -> bool:
    """An assignment through a subscript whose index is computed (a name,
    call or expression; not a constant or a plain slice): an index_put_ on
    a tensor."""
    if not isinstance(target, ast.Subscript):
        return False
    idx = target.slice
    elts = idx.elts if isinstance(idx, ast.Tuple) else [idx]
    return any(not isinstance(e, (ast.Constant, ast.Slice)) for e in elts)


def _host_sync(node: ast.Call) -> str | None:
    f = node.func
    if isinstance(f, ast.Attribute) and f.attr in _SYNC_METHODS \
            and not node.args:
        return f".{f.attr}()"
    if (isinstance(f, ast.Name) and f.id == "bool" and node.args
            and not isinstance(node.args[0], ast.Constant)):
        return "bool(...)"
    return None


def _torch_test(expr: ast.AST, aliases: _Aliases) -> bool:
    """A torch call (or a tensor's .any() / .all()) inside an if/while
    test."""
    for n in ast.walk(expr):
        if aliases.is_torch_call(n):
            return True
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr in ("any", "all")):
            return True
    return False


_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)


def lint_source(src: str, rel_path: str) -> list[LintViolation]:
    """Lint one file's source. ``rel_path`` is src/repro_torch-relative
    (it scopes the spine, captured-body and owner rules and is reported
    verbatim)."""
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return [LintViolation(rel_path, e.lineno or 0, "parse-error",
                              f"file does not parse: {e.msg}")]
    aliases = _Aliases()
    aliases.collect(tree)
    rel = rel_path.replace(os.sep, "/")
    in_spine = rel in SPINE_MODULES
    captured_fns = CAPTURED_BODIES.get(rel, ())
    raw: list[LintViolation] = []

    def flag(node: ast.AST, rule: str, message: str) -> None:
        raw.append(LintViolation(rel_path, getattr(node, "lineno", 0),
                                 rule, message))

    def visit(node: ast.AST, captured: bool) -> None:
        strict = in_spine or captured
        where = "a spine module" if in_spine else "a captured step's body"
        if isinstance(node, _FUNC_NODES):
            defaults = list(node.args.defaults) + [
                d for d in node.args.kw_defaults if d is not None]
            for d in defaults:
                if isinstance(d, (ast.List, ast.Dict, ast.Set,
                                  ast.ListComp, ast.DictComp, ast.SetComp)):
                    flag(d, "mutable-default",
                         f"mutable default in '{node.name}' is shared "
                         f"across every call")
            inner = captured or node.name in captured_fns
            for child in ast.iter_child_nodes(node):
                visit(child, inner)
            return

        if isinstance(node, ast.Call):
            kind = aliases.capture_or_library(node.func)
            if kind == "capture" and rel != CAPTURE_OWNER:
                flag(node, "raw-jit",
                     f"CUDA-graph capture outside {CAPTURE_OWNER} — "
                     f"capture through the slot core's _run_step")
            elif kind == "library" and rel != LIBRARY_OWNER:
                flag(node, "raw-jit",
                     f"library load outside {LIBRARY_OWNER} — load through "
                     f"_build.load")
            if in_spine and _is_scatter_call(node):
                flag(node, "scatter-write",
                     f".{node.func.attr} in a convert-spine module — use "
                     f"the gather router")
            sync = _host_sync(node) if strict else None
            if sync:
                flag(node, "traced-if",
                     f"{sync} in {where} reads a device value on the host")
            if (strict and isinstance(node.func, ast.Attribute)
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id in aliases.np
                    and node.func.attr not in _NP_META):
                flag(node, "host-numpy-in-jit",
                     f"np.{node.func.attr} in {where} computes on the "
                     f"host")

        if in_spine and isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            if any(_computed_index(t) for t in targets):
                flag(node, "scatter-write",
                     "an assignment through a computed index in a "
                     "convert-spine module is an index_put_ — use the "
                     "gather router")

        if strict and isinstance(node, (ast.If, ast.While)) \
                and _torch_test(node.test, aliases):
            flag(node, "traced-if",
                 f"Python control flow on a torch expression in {where} "
                 f"syncs the host — use torch.where or branch on static "
                 f"metadata")

        for child in ast.iter_child_nodes(node):
            visit(child, captured)

    visit(tree, False)

    marks = _suppressions(src)
    lines = src.splitlines()

    def suppressed(v: LintViolation) -> bool:
        # a matching marker suppresses even without a reason: the
        # bare-suppression violation below replaces the finding
        ln = v.line
        while ln >= 1:
            if ln in marks and marks[ln][0] == v.rule:
                return True
            if ln == v.line:
                ln -= 1
                continue
            if ln <= len(lines) and lines[ln - 1].lstrip().startswith("#"):
                ln -= 1
                continue
            return False
        return False

    out = [v for v in raw if not suppressed(v)]
    for ln, (rule, has_reason) in sorted(marks.items()):
        if not has_reason:
            out.append(LintViolation(
                rel_path, ln, "bare-suppression",
                f"allow-{rule} marker has no reason"))
        elif rule not in RULES and rule != "parse-error":
            out.append(LintViolation(
                rel_path, ln, "bare-suppression",
                f"allow-{rule} names no known rule "
                f"({', '.join(sorted(RULES))})"))
    return sorted(out, key=lambda v: (v.line, v.rule))


def lint_file(path: str, root: str) -> list[LintViolation]:
    with open(path) as f:
        src = f.read()
    return lint_source(src, os.path.relpath(path, root))


def lint_tree(root: str | None = None) -> list[LintViolation]:
    """Lint every .py file under ``root`` (default: the src/repro_torch
    tree this module ships in). Violations are tree-relative and
    sorted."""
    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out: list[LintViolation] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                out.extend(lint_file(os.path.join(dirpath, fn), root))
    return sorted(out, key=lambda v: (v.path, v.line, v.rule))
