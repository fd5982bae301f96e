"""The yardstick's arithmetic: the chip's peaks (``peaks.json``), the
operations a model's layer equations need (``model_<kind>.py``, found by the
configuration's model kind) and the bytes a stage must move
(``preprocess.py``, ``convert.py``). Every count reads the work the
inputs need, not what a kernel does, so a later change that renames or
fuses kernels leaves it as it is."""
from __future__ import annotations

import importlib
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def peaks() -> dict:
    return json.loads((HERE / "peaks.json").read_text())


def model_counts(kind: str):
    """The module that counts a ``kind`` model's forward operations."""
    return importlib.import_module(f"{__name__}.model_{kind}")
