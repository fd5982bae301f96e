"""Fault-tolerant checkpointing: atomic, versioned, keep-k, resumable (port
of ``repro/train/checkpoint.py``).

Layout: ``<dir>/step_<n:09d>/arrays.npz`` + ``meta.json``, with a
two-phase commit (write to ``step_<n>.tmp``, fsync, atomic rename).
``latest_step`` scans committed checkpoints only, so a crash mid-write
never corrupts a restore. What is saved is a flat dictionary name →
tensor (the port's keys: parameter names, ``m.<name>``, ``v.<name>``,
``step``); npz holds no bfloat16, so a bf16 tensor is stored as its
uint16 view with its dtype in ``meta.json``, as the reference stores its
extension dtypes.
"""
from __future__ import annotations

import json
import os
import re
import shutil

import numpy as np
import torch

def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    t = t.detach().cpu()
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:  # npz holds no bf16: its uint16 view
        return t.view(torch.int16).numpy().view(np.uint16), name
    return t.numpy(), name


def _from_numpy(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    dtype = getattr(torch, dtype_name)
    if dtype == torch.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(dtype)
    return torch.from_numpy(a).to(dtype)


def save(ckpt_dir: str, step: int, tensors: dict[str, torch.Tensor],
         keep: int = 3) -> str:
    """Atomic checkpoint commit of ``tensors``. Returns the committed path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    keys = list(tensors)
    arrays, dtypes = {}, []
    for i, key in enumerate(keys):
        arrays[f"a{i}"], dt = _to_numpy(tensors[key])
        dtypes.append(dt)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    meta = {"step": step, "keys": keys, "dtypes": dtypes}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, final)  # commit point
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int) -> None:
    for s in all_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:09d}"),
                      ignore_errors=True)


def all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "meta.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str) -> int | None:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int, like: dict[str, torch.Tensor]
            ) -> tuple[dict[str, torch.Tensor], dict]:
    """The checkpoint of ``step`` as tensors on the devices of ``like``,
    whose keys, shapes and dtypes it must match, and its meta."""
    path = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if list(like) != meta["keys"]:
        raise ValueError("checkpoint / model structure mismatch")
    out = {}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for i, (key, dt) in enumerate(zip(meta["keys"], meta["dtypes"])):
            t = _from_numpy(data[f"a{i}"], dt)
            want = like[key]
            if t.shape != want.shape or t.dtype != want.dtype:
                raise ValueError(f"checkpoint entry {key}: {t.dtype} "
                                 f"{tuple(t.shape)}, expected {want.dtype} "
                                 f"{tuple(want.shape)}")
            out[key] = t.to(want.device)
    return out, meta
