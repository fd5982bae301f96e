"""GnnServeEngine — batched GNN inference over the slot core (port of
``repro/serve/gnn.py``).

Every slot runs the whole request-to-prediction dataflow on the card:
neighbour sampling → reindex + subgraph re-conversion
(``pipeline.sample_subgraph``) → feature gather → the GNN forward (any of
the four families, ``models/gnn.py``) → argmax. One step function runs
every slot as a lane, one after another through the single-request
``slot_fn``, idle slots on their stale or SENTINEL seeds, at the same
padded ``seed_cap`` shapes, so a request's predictions equal a
sequential per-request ``slot_fn`` loop bit for bit:

* each slot samples its own subgraph (no cross-request dedup);
* the per-request key is folded from the request id, never the slot or
  the step, and laid out on the host as its key schedule
  (``prng.key_schedule``, in ``cfg.selection``'s layout);
* the forward uses one deterministic segment sum on both legs.

The state is static device tensors (seeds, key schedules, active flags,
the emission rows). Admission seats a wave with one stacked
host-to-device copy into them. On the card the first step runs eagerly
(the warm-up, with host syncs made errors) and is captured once as a CUDA
graph on a memory pool of the engine's own, where a lane's intermediates
are freed before the next lane allocates; every later step replays it.
On the CPU the same step function runs eagerly. ``step_cache_size()`` (the
slot core's zero-recapture guard) counts the step programs built; a
program is bound to the tensors it was built on, and a step raises if a
state, graph, feature or weight tensor was rebound since (a replay would
read the old buffers): new values are written into them in place.

``cfg`` pins the preprocessing dispatch. ``launch/serve.py`` names the two
configurations the port serves: ``SLICE_CFG`` (global_radix sorts through
the digit-pass kernels, the fused rank epilogue, the pointer segment sum on
the column-scan kernel) and ``MERGE_CFG`` (chunked_merge sorts through the
chunk-sort and fused-merge kernels, the unfused set-count pointer build,
and, with the model's ``use_pallas_agg``, the segment-sum kernel).

The graph is mutable under traffic: ``submit_update(inserts, deletes)``
enqueues a ``delta_cap``-bucketed edge batch on the same FIFO as the
queries. The run loop holds it until every earlier request retired,
splices it in through the incremental conversion
(``engine/service.apply_delta_jit``, output capacity pinned to the
engine's index bucket) and copies the new pointers, indices and edge
count into the engine's own CSC tensors, in place and on the stream the
step runs on. The captured step reads those addresses, so it serves the
post-update graph without being captured again.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import pipeline, prng
from repro_torch.core.costmodel import EngineConfig
from repro_torch.core.delta import EdgeDelta
from repro_torch.core.graph import CSC, SENTINEL, next_pow2, resolve_device
from repro_torch.core.sampling import DEFAULT_WINDOW
from repro_torch.engine.service import apply_delta_jit
from repro_torch.kernels import launch_counts
from repro_torch.models.gnn import subgraph_batch

from .request import Request
from .slots import SlotEngineBase

# The prompt of a control request: a streamed graph update enqueued by
# ``submit_update`` (its EdgeDelta rides ``Request.payload``; the row the
# feeder pads from this marker is never read).
UPDATE_MARKER = -2


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


def build_step(fanouts: tuple[int, ...], seed_cap: int, cfg: EngineConfig):
    """The one step program: every slot's ``slot_fn`` as a lane, then the
    emission rows. ``state`` holds seeds [S, seed_cap] int32, key
    schedules [S, K, 2] int64 (``cfg.selection``'s layout), active [S]
    int32 and the emission [S, 1 + seed_cap] int32, all written in
    place: the flag column is the active flags, an inactive row's
    predictions are 0, and the step clears every flag (one-shot
    retirement)."""
    slot_fn = build_slot_fn(fanouts, seed_cap, cfg)

    def step(params, state) -> None:
        with torch.inference_mode():
            flag, emission = state["active"], state["emission"]
            emission[:, 0] = flag
            for i in range(flag.shape[0]):
                preds = slot_fn(params, state["seeds"][i],
                                state["schedules"][i])
                emission[i, 1:] = torch.where(flag[i] != 0, preds,
                                              torch.zeros_like(preds))
            flag.zero_()

    return step


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
    per-seed class predictions in ``Request.tokens_out``.
    ``submit_update(inserts, deletes)`` enqueues a graph update on the same
    FIFO. ``model`` is any model of ``models/gnn.py`` (``gnn_model``);
    ``cfg`` pins the preprocessing dispatch (sort/reindex strategy, kernel
    routing, selection). The graph, features and model live on ``device``
    (a missing card raises).
    """

    def __init__(self, model, csc: CSC, features, *,
                 fanouts: tuple[int, ...] | None = None, n_slots: int = 4,
                 seed_cap: int = 8, cfg: EngineConfig | None = None,
                 key_seed: int = 0, device="cuda", delta_cap: int = 64):
        fanouts = tuple(fanouts if fanouts is not None
                        else model.cfg.sample_sizes)
        if not fanouts:
            raise ValueError("fanouts required (cfg.sample_sizes is empty)")
        seed_cap = next_pow2(seed_cap)
        n_slots = next_pow2(n_slots)
        super().__init__(n_slots=n_slots, row_cap=seed_cap, route=gnn_route,
                         device=resolve_device(device),
                         feeder_depth=4 * n_slots,
                         pad_value=SENTINEL, admit_window=2e-3)
        self.fanouts = fanouts
        self.seed_cap = seed_cap
        self.delta_cap = next_pow2(delta_cap)
        self.engine_cfg = cfg or EngineConfig()
        self.n_nodes = csc.n_nodes
        self.base_key = prng.PRNGKey(key_seed)
        # the engine's own copy of the graph: updates write into it in place
        csc = csc.to(self.device)
        self.params = {
            "gnn": model.to(self.device).eval(),
            "csc": CSC(csc.ptr.clone(), csc.idx.clone(), csc.n_edges.clone(),
                       csc.n_nodes),
            "features": torch.as_tensor(features, dtype=torch.float32
                                        ).to(self.device)}
        key_rows = sum(prng.schedule_rows(self.engine_cfg.selection, fanouts,
                                          DEFAULT_WINDOW))
        self.state = {
            "seeds": torch.full((n_slots, seed_cap), SENTINEL,
                                dtype=torch.int32, device=self.device),
            "schedules": torch.zeros((n_slots, key_rows, 2),
                                     dtype=torch.int64, device=self.device),
            "active": torch.zeros((n_slots,), dtype=torch.int32,
                                  device=self.device),
            "emission": torch.zeros((n_slots, 1 + seed_cap),
                                    dtype=torch.int32, device=self.device)}
        self.slot_fn = build_slot_fn(fanouts, seed_cap, self.engine_cfg)
        self.step_fn = build_step(fanouts, seed_cap, self.engine_cfg)

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
        """Enqueue one streamed graph update: ``inserts`` / ``deletes`` are
        iterables of ``(dst, src)`` pairs, bucketed to ``delta_cap`` so
        every update is one dispatch entry of the same shapes. It applies
        once every earlier request retired; every later request samples
        the post-update graph. Its Request finishes with an empty
        ``tokens_out`` when the update was applied."""
        ins = [(int(d), int(s)) for d, s in inserts]
        dels = [(int(d), int(s)) for d, s in deletes]
        if not ins and not dels:
            raise ValueError("empty update: no inserts and no deletes")
        if max(len(ins), len(dels)) > self.delta_cap:
            raise ValueError(
                f"update size {max(len(ins), len(dels))} exceeds the "
                f"engine delta bucket {self.delta_cap}: split the batch or "
                "construct the engine with a larger delta_cap")
        bad = [v for dd, ss in ins + dels for v in (dd, ss)
               if not 0 <= v < self.n_nodes]
        if bad:
            raise ValueError(f"update VIDs out of range [0, {self.n_nodes})"
                             f": {bad}")
        delta = EdgeDelta.from_arrays(
            [d for d, _ in ins], [s for _, s in ins],
            [d for d, _ in dels], [s for _, s in dels],
            n_nodes=self.n_nodes, capacity=self.delta_cap,
            device=self.device)
        return self._enqueue([UPDATE_MARKER], max_new=0, payload=delta)

    def _classify_prep(self, prep) -> str:
        return ("apply" if isinstance(prep.request.payload, EdgeDelta)
                else "seat")

    def _apply_control(self, prep) -> None:
        """Apply one held graph update (no slot is active): the incremental
        conversion through ``apply_delta_jit`` with the output capacity
        pinned to the engine's index bucket, then the result copied into
        the engine's own ``ptr``, ``idx`` and ``n_edges`` in place, on the
        current stream (the one the step replays on, behind it). The
        bindings stay, so the captured step serves the new graph. An
        update whose inserts could overflow the bucket raises and leaves
        the graph as it was."""
        csc = self.params["csc"]
        cap = int(csc.idx.shape[0])
        delta = prep.request.payload
        # two scalar reads (the step before synchronised on its emission)
        if int(csc.n_edges) + int(delta.n_ins) > cap:
            raise RuntimeError(
                f"graph update overflows the serve index bucket ({cap} "
                "slots): growing it would rebind the captured step; restart "
                "the engine with a larger graph capacity")
        new = apply_delta_jit(csc, delta, cfg=self.engine_cfg,
                              out_capacity=cap)
        csc.ptr.copy_(new.ptr)
        csc.idx.copy_(new.idx)
        csc.n_edges.copy_(new.n_edges)

    def request_key(self, rid: int) -> prng.Key:
        """The per-request key, folded from the request id alone — the
        sequential oracle derives its keys through this same method."""
        return prng.fold_in(self.base_key, rid)

    def kernel_launches(self) -> dict[str, int]:
        """Launch counters of the kernels (process-wide)."""
        return launch_counts()

    def _admit_many(self, wave: list) -> None:
        """Seat a wave: [slot, seed row, key schedule] per request, stacked
        on the host into one int64 block and copied to the device once,
        then scattered into the state rows (outside any captured step)."""
        cap = self.seed_cap
        keys = self.state["schedules"].shape[1]
        block = np.empty((len(wave), 1 + cap + 2 * keys), np.int64)
        for i, (slot, prep) in enumerate(wave):
            block[i, 0] = slot
            block[i, 1:1 + cap] = prep.row
            block[i, 1 + cap:] = prng.key_schedule(
                self.request_key(prep.request.rid), self.fanouts,
                self.engine_cfg.selection, DEFAULT_WINDOW).reshape(-1).numpy()
        dev = torch.from_numpy(block).to(self.device)
        slots = dev[:, 0]
        st = self.state
        st["seeds"][slots] = dev[:, 1:1 + cap].to(torch.int32)
        st["schedules"][slots] = dev[:, 1 + cap:].reshape(
            len(wave), -1, 2)
        st["active"][slots] = 1

    def _bound_tensors(self) -> dict[str, torch.Tensor]:
        """Every tensor the step reads or writes: the state, the graph,
        the features and the model's weights."""
        csc = self.params["csc"]
        named = {"csc.ptr": csc.ptr, "csc.idx": csc.idx,
                 "csc.n_edges": csc.n_edges,
                 "features": self.params["features"]}
        named.update((f"gnn.{k}", t) for k, t in
                     self.params["gnn"].state_dict(keep_vars=True).items())
        named.update((f"state.{k}", t) for k, t in self.state.items())
        return named

    def _step(self) -> np.ndarray:
        """Run every slot; returns the [S, 1 + seed_cap] emission rows
        (flag, predictions). The step clears the active flags itself."""
        self._run_step()
        return self.state["emission"].cpu().numpy()
