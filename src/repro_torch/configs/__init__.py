"""Model configurations of the port (the GNN family only)."""
from __future__ import annotations

from . import graphsage_reddit

_CONFIGS = {"graphsage-reddit": graphsage_reddit}


def get_config(arch: str, smoke: bool = False):
    if arch not in _CONFIGS:
        raise KeyError(f"unknown or unported arch {arch!r}; "
                       f"ported: {sorted(_CONFIGS)}")
    mod = _CONFIGS[arch]
    return mod.smoke_config() if smoke else mod.config()
