"""repro_torch.analysis — static and census checks of the invariants the
cost model prices (port of ``repro/analysis``).

Two passes behind one CLI (``python -m repro_torch.analysis``):

* **census contracts** (``census.py`` + ``contracts.py`` +
  ``checker.py``): each hot path runs once under a census of the aten
  ops it issues outside the kernel scopes, its kernel wrappers' calls
  and launches and its collective bytes, and must match the
  model-derived invariants: scatter-free spines, the launch census equal
  to the cost model's (``costmodel.convert_launch_count`` ...), the
  native-sort census, collective-byte ceilings, cache guards. It stands
  in for the reference's HLO contracts (``repro/launch/hlo_analysis.py``
  and ``hlo_inspect.py`` read XLA's HLO, which a torch program has not).
* **AST lint** (``lint.py``): repo-specific rules over
  ``src/repro_torch`` for the bug classes that exist in torch code.

``lint`` imports nothing but the standard library.
"""
from repro_torch.analysis.lint import (RULES, LintViolation, lint_file,
                                       lint_source, lint_tree)

__all__ = ["RULES", "LintViolation", "lint_file", "lint_source",
           "lint_tree"]
