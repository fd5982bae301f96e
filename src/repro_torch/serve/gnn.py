"""GnnServeEngine — batched GNN inference over the slot core (port of
``repro/serve/gnn.py``).

Every occupied slot runs the whole request-to-prediction dataflow on the
card: neighbour sampling → reindex + subgraph re-conversion
(``pipeline.sample_subgraph``) → feature gather → GraphSAGE forward →
argmax. The step runs the slots as a Python loop over ``slot_fn``, every
slot at the same padded ``seed_cap`` shapes, so a request's predictions
equal a sequential per-request ``slot_fn`` loop bit for bit:

* each slot samples its own subgraph (no cross-request dedup);
* the per-request key is folded from the request id, never the slot or
  the step;
* the forward uses one deterministic segment sum on both legs.

``cfg`` pins the preprocessing dispatch. ``launch/serve.py`` names the two
configurations the port serves: ``SLICE_CFG`` (global_radix sorts through
the digit-pass kernels, the fused rank epilogue, the pointer-based segment
sum) and ``MERGE_CFG`` (chunked_merge sorts through the chunk-sort and
fused-merge kernels, the unfused set-count pointer build, and, with the
model's ``use_pallas_agg``, the segment-sum kernel).

Streamed graph updates (``submit_update``) are not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import pipeline, prng
from repro_torch.core.costmodel import EngineConfig
from repro_torch.core.graph import CSC, SENTINEL, next_pow2, resolve_device
from repro_torch.kernels import launch_counts
from repro_torch.models.gnn import GraphSAGE, subgraph_batch

from .request import Request
from .slots import SlotEngineBase


def build_slot_fn(fanouts: tuple[int, ...], seed_cap: int,
                  cfg: EngineConfig):
    """One slot's whole request: sample → convert → forward → argmax.

    ``bundle`` packs everything request-independent ({"gnn": model, "csc":
    graph, "features": table}); ``seeds`` is the SENTINEL-padded
    [seed_cap] row and ``key`` the request's PRNG key.
    """

    def slot_fn(bundle, seeds: torch.Tensor, key) -> torch.Tensor:
        with torch.inference_mode():
            sub = pipeline.sample_subgraph(bundle["csc"], seeds, fanouts, key,
                                           cfg)
            out = bundle["gnn"](subgraph_batch(sub, bundle["features"]))
            # first-occurrence numbering: the seeds own the first new VIDs
            return torch.argmax(out[:seed_cap], dim=-1).to(torch.int32)

    return slot_fn


def gnn_route(req: Request, emission) -> bool | None:
    """One-shot retirement: the emission row is ``[active_flag, pred_0 ..
    pred_cap-1]``; a flagged row retires the request with its first
    ``len(seeds)`` predictions."""
    row = np.asarray(emission)
    if int(row[0]) == 0:
        return None
    req.tokens_out.extend(int(p) for p in row[1:1 + len(req.prompt)])
    return True


class GnnServeEngine(SlotEngineBase):
    """Admission-controlled GNN inference over ``n_slots`` request slots.

    ``submit(seeds)`` enqueues one request for up to ``seed_cap`` batch
    nodes; ``run()`` serves every queued request and retires each with its
    per-seed class predictions in ``Request.tokens_out``. ``cfg`` pins the
    preprocessing dispatch (sort/reindex strategy, kernel routing). The
    graph, features and model live on ``device`` (a missing card raises).
    """

    def __init__(self, model: GraphSAGE, csc: CSC, features, *,
                 fanouts: tuple[int, ...] | None = None, n_slots: int = 4,
                 seed_cap: int = 8, cfg: EngineConfig | None = None,
                 key_seed: int = 0, device="cuda"):
        fanouts = tuple(fanouts if fanouts is not None
                        else model.cfg.sample_sizes)
        if not fanouts:
            raise ValueError("fanouts required (cfg.sample_sizes is empty)")
        seed_cap = next_pow2(seed_cap)
        n_slots = next_pow2(n_slots)
        super().__init__(n_slots=n_slots, row_cap=seed_cap, route=gnn_route,
                         feeder_depth=4 * n_slots,
                         pad_value=SENTINEL, admit_window=2e-3)
        self.device = resolve_device(device)
        self.fanouts = fanouts
        self.seed_cap = seed_cap
        self.engine_cfg = cfg or EngineConfig()
        self.n_nodes = csc.n_nodes
        self.base_key = prng.PRNGKey(key_seed)
        self.params = {
            "gnn": model.to(self.device).eval(),
            "csc": csc.to(self.device),
            "features": torch.as_tensor(features, dtype=torch.float32
                                        ).to(self.device)}
        self.state = {
            "seeds": torch.full((n_slots, seed_cap), SENTINEL,
                                dtype=torch.int32, device=self.device),
            "key": [self.base_key] * n_slots,
            "active": [False] * n_slots}
        self.slot_fn = build_slot_fn(fanouts, seed_cap, self.engine_cfg)

    def submit(self, seeds) -> Request:
        """Enqueue one inference request for ``seeds`` (node ids)."""
        seeds = [int(s) for s in seeds]
        if not 1 <= len(seeds) <= self.seed_cap:
            raise ValueError(
                f"seed count {len(seeds)} not in [1, {self.seed_cap}]")
        bad = [s for s in seeds if not 0 <= s < self.n_nodes]
        if bad:
            raise ValueError(f"seed ids out of range [0, {self.n_nodes}): "
                             f"{bad}")
        return self._enqueue(seeds)

    def submit_update(self, inserts, deletes=()) -> Request:
        raise NotImplementedError(
            "streamed graph updates need the delta-merge path "
            "(repro/core/delta.py), not ported yet")

    def request_key(self, rid: int) -> prng.Key:
        """The per-request key, folded from the request id alone — the
        sequential oracle derives its keys through this same method."""
        return prng.fold_in(self.base_key, rid)

    def kernel_launches(self) -> dict[str, int]:
        """Launch counters of the kernels (process-wide)."""
        return launch_counts()

    def _admit_many(self, wave: list) -> None:
        slots = torch.tensor([slot for slot, _ in wave], device=self.device)
        rows = torch.from_numpy(np.stack([p.row for _, p in wave]))
        self.state["seeds"][slots] = rows.to(self.device)
        for slot, prep in wave:
            self.state["key"][slot] = self.request_key(prep.request.rid)
            self.state["active"][slot] = True

    def _step(self) -> np.ndarray:
        """Run every active slot's request; returns the [S, 1 + seed_cap]
        emission rows (flag, predictions) and clears the active flags."""
        emitted = np.zeros((self.n_slots, 1 + self.seed_cap), np.int32)
        active = [s for s, a in enumerate(self.state["active"]) if a]
        preds = [self.slot_fn(self.params, self.state["seeds"][s],
                              self.state["key"][s]) for s in active]
        if preds:
            emitted[active, 0] = 1
            emitted[active, 1:] = torch.stack(preds).cpu().numpy()
        self.state["active"] = [False] * self.n_slots
        return emitted
