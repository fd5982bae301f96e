"""Execution modes and dynamic reconfiguration (port of
``repro/core/reconfig.py``, paper §V-B, §VI).

The engine management lives in ``repro_torch.engine.service`` (profiling,
cost-model scoring, pow2 buckets, the shared dispatch cache); the paper's
three system variants keep their names here:

* ``AutoPre`` — the UPE region statically split into an ordering-only and
  a selection-only engine (here: half the lanes).
* ``StatPre`` — one time-multiplexed engine with a fixed configuration,
  tuned for an intermediate graph.
* ``DynPre`` — StatPre plus runtime reconfiguration.

"Reprogramming a bitstream" is switching to another configuration's
kernel routing (``pipeline.kernel_fns``), which the service's module-level
table builds once a configuration and every later engine reuses. The
paper's reconfiguration latency is modelled explicitly, so the Fig. 28
trade-off can be reproduced.
"""
from __future__ import annotations

import dataclasses

from .costmodel import (Calibration, EngineConfig, Workload,
                        bitstream_library, choose_config, estimate_seconds)

# Paper: 230 ms full reconfiguration; halved when only one region changes.
RECONFIG_S_FULL = 0.230
RECONFIG_S_PARTIAL = 0.115


@dataclasses.dataclass
class ReconfigDecision:
    reconfigure: bool
    config: EngineConfig
    predicted_gain_s: float
    reconfig_cost_s: float


def decide(w: Workload, current: EngineConfig | None,
           library: list[EngineConfig], cal: Calibration,
           switch_threshold: float = 1.5,
           reconfig_cost_s: float = RECONFIG_S_PARTIAL) -> ReconfigDecision:
    """DynPre's rule: score the library, switch when the predicted gain
    over the current configuration amortises the reconfiguration. The
    candidate carries a concrete ``sort_strategy`` and
    ``reindex_strategy`` (``choose_config``)."""
    cand = choose_config(w, library, cal)
    if current is None:
        return ReconfigDecision(True, cand, float("inf"), reconfig_cost_s)
    cur = estimate_seconds(current, w, cal)["total"]
    new = estimate_seconds(cand, w, cal)["total"]
    gain = cur - new
    go = cur > new * switch_threshold and gain > reconfig_cost_s * 0.1
    return ReconfigDecision(go, cand, gain, reconfig_cost_s)


class Engine:
    """A preprocessing engine bound to one EngineConfig; it dispatches
    through the service's module-level ``preprocess_jit`` (no cache of its
    own), with its inputs as given (only ``PreprocService`` buckets)."""

    def __init__(self, cfg: EngineConfig, fanouts: tuple[int, ...]):
        self.cfg = cfg
        self.fanouts = fanouts

    def preprocess(self, coo, batch_nodes, key):
        from repro_torch.engine.service import preprocess_jit
        return preprocess_jit(coo, batch_nodes, self.fanouts, key, self.cfg)


class DynPre:
    """Dynamic reconfiguration controller."""

    def __init__(self, fanouts: tuple[int, ...],
                 library: list[EngineConfig] | None = None,
                 cal: Calibration | None = None,
                 switch_threshold: float = 1.5,
                 reconfig_cost_s: float = RECONFIG_S_PARTIAL):
        self.library = library or bitstream_library()
        self.cal = cal or Calibration()
        self.fanouts = fanouts
        self.threshold = switch_threshold
        self.reconfig_cost_s = reconfig_cost_s
        self.engine: Engine | None = None
        self.n_reconfigs = 0

    def profile(self, coo, batch_size: int) -> Workload:
        """Graph metadata capture (one host read of the edge count)."""
        return Workload(n=coo.n_nodes, e=int(coo.n_edges),
                        l=len(self.fanouts), k=max(self.fanouts),
                        b=batch_size)

    def decide(self, w: Workload) -> ReconfigDecision:
        current = self.engine.cfg if self.engine is not None else None
        return decide(w, current, self.library, self.cal, self.threshold,
                      self.reconfig_cost_s)

    def ensure(self, coo, batch_size: int) -> Engine:
        d = self.decide(self.profile(coo, batch_size))
        if d.reconfigure or self.engine is None:
            self.engine = Engine(d.config, self.fanouts)
            self.n_reconfigs += 1
        return self.engine

    def preprocess(self, coo, batch_nodes, key):
        eng = self.ensure(coo, int(batch_nodes.shape[0]))
        return eng.preprocess(coo, batch_nodes, key)


def statpre(fanouts: tuple[int, ...],
            cfg: EngineConfig | None = None) -> Engine:
    """StatPre: fixed intermediate-graph tuning (paper: tuned for MV)."""
    return Engine(cfg or EngineConfig(w_upe=4096, n_upe=16,
                                      w_scr=2048, n_scr=512), fanouts)


def autopre(fanouts: tuple[int, ...]) -> Engine:
    """AutoPre: statically split lanes, half for ordering and half for
    selection (in the cycle model, half of n_upe for each stage)."""
    return Engine(EngineConfig(w_upe=4096, n_upe=8, w_scr=2048, n_scr=512),
                  fanouts)
