"""ServeEngine — continuous-batching greedy decode over fixed pow2 slots
(port of ``repro/serve/engine.py``).

The LM client of the slot core (``serve.slots``): this module owns what
is decode-specific — the step over ``models.transformer.lm_decode_step``,
the KV cache, the prompt rows — while queueing, FIFO admission, cooling,
stats, the step program and the run loop come from
:class:`~repro_torch.serve.slots.SlotEngineBase`.

* **Fixed pow2 buckets.** The slot count, the cache length and the prompt
  buffer are bucketed once, at construction, so a request of any length
  runs the one step program; ``step_cache_size()`` stays 1.
* **One step for prefill and decode.** Every step feeds every slot one
  token: a slot still inside its prompt takes its next prompt token
  (teacher forcing), a slot past it its last output, at its own position
  (``lm_decode_step`` under a [S] position vector). A freshly admitted
  request prefills while its neighbours generate.
* **The slot cache.** One ``make_cache`` buffer of ``n_slots`` rows; each
  slot attends its own positions below its length, so a reused slot needs
  no reset (stale rows sit at or past its position and are never read).
* **Any LM config.** gemma2-9b, granite-moe-1b-a400m, codeqwen1.5-7b,
  qwen1.5-32b and grok-1-314b (``configs``). Under MoE the experts'
  capacity comes from the step's tokens, one a slot, idle slots included
  (``models.moe``), so, as in the reference, a request's tokens may
  depend on its neighbours; dense configs keep every slot independent.
* **The step captured, one step in flight.** The state (cache, positions,
  prompts, prompt lengths, last tokens, active flags, emitted tokens) is
  static device tensors written in place; admission writes a wave's rows
  with one host-to-device copy, outside the step. On the card the step is
  captured once as a CUDA graph after an eager warm-up (the slot core).
  Each step's tokens are copied out on the stream into one of two pinned
  host buffers behind an event, so the next replay cannot overwrite them
  before the host has read them: the run loop routes step k - 1's tokens
  (waiting on its event only) while step k runs, and a retired slot cools
  for one cycle (``scheduler.Scheduler``). On the CPU the same step runs
  eagerly.

* **On a mesh** (a ``torch.distributed`` ``DeviceMesh``; every rank runs
  an engine over the same request stream): each rank holds the model and
  the slot state whole and its shard of the cache
  (``dist.sharding.lm_cache_shardings(seq_sharded=True)``: a stack's
  positions over the dp ranks where they divide, its KV heads over
  ``model``). A new token's k and v are written only by the rank that owns
  its position, and the attention combines the ranks' slices
  (``dist.collectives.seq_sharded_decode_attn_fn``). Rank 0's admissions
  are broadcast, so every rank takes the same steps and issues the same
  collectives in the same order (``slots.AdmissionAgreement``). At world
  1 no stack is cut: the engine holds no shard, issues no collective and
  its step is the single-device one, captured on the card as without a
  mesh. Above world 1 on the card the step would be captured with its
  NCCL collectives inside; that has not run (one card holds one NCCL
  rank). A gloo mesh runs the step eagerly, on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graph import next_pow2, resolve_device
from repro_torch.dist.collectives import seq_sharded_decode_attn_fn
from repro_torch.dist.groups import check_mesh, dp_rank, model_rank
from repro_torch.dist.sharding import Shard, lm_cache_shardings, local_shape
from repro_torch.models.transformer import (LM, CacheShard, lm_decode_step,
                                            make_cache)

from .request import Request
from .scheduler import NO_TOKEN
from .slots import (AdmissionAgreement, SlotEngineBase, ServeStats,
                    deactivate_update)

__all__ = ["ServeEngine", "ServeStats", "build_step"]


def build_step(prompt_cap: int, shards: dict | None = None):
    """The one step program, ``step(model, state) -> logits [S, V]``: the
    input token of every slot (its next prompt token or its last output),
    one decode step at the slots' positions, the slot state advanced in
    place. ``state["emitted"]`` [S] gets each slot's new token where it is
    active and past its prompt, ``NO_TOKEN`` elsewhere. ``shards``: the
    rank's ``CacheShard`` of each cut cache stack (on a mesh)."""

    def step(model: LM, state: dict) -> torch.Tensor:
        with torch.no_grad():
            pos = state["pos"]
            in_prompt = pos < state["prompt_len"]
            idx = torch.clamp(pos, 0, prompt_cap - 1).to(torch.int64)
            prompt_tok = torch.gather(state["prompt"], 1, idx[:, None])[:, 0]
            inp = torch.where(in_prompt, prompt_tok, state["last_tok"])
            nxt, logits = lm_decode_step(model, state["cache"], inp[:, None],
                                         pos, return_logits=True,
                                         shards=shards)
            tok = nxt[:, 0]
            active = state["active"]
            new_pos = torch.where(active, pos + 1, pos)
            # the output at prompt position P - 1 is the first generated
            # token; earlier outputs are teacher forcing's by-products
            emitting = active & (new_pos >= state["prompt_len"])
            state["last_tok"].copy_(torch.where(emitting, tok,
                                                state["last_tok"]))
            state["pos"].copy_(new_pos)
            state["emitted"].copy_(torch.where(emitting, tok, NO_TOKEN))
            return logits

    return step


class ServeEngine(SlotEngineBase):
    """Continuous-batching decode over ``n_slots`` request slots.

    ``submit(prompt, max_new)`` from any thread, ``close_submissions()`` to
    end the stream, ``run()`` to serve it: each request retires with its
    greedy tokens in ``Request.tokens_out`` (at most ``max_new``; none past
    ``eos_id``). ``model`` is a ``models.transformer.LM`` of ``cfg`` on
    ``device`` (a missing card raises). ``mesh``: a ``DeviceMesh`` over an
    initialized process group, of ``device``'s type (the module's
    docstring)."""

    def __init__(self, cfg, model: LM, *, n_slots: int = 8,
                 max_len: int = 128, prompt_cap: int | None = None,
                 mesh=None, eos_id: int | None = None,
                 feeder_depth: int = 2, device="cuda"):
        if mesh is not None:
            check_mesh(mesh)
            if mesh.device_type != resolve_device(device).type:
                raise ValueError(f"a {mesh.device_type} mesh serving on "
                                 f"{device}")
        if cfg != model.cfg:
            raise ValueError("cfg is not the model's configuration")
        self.cfg = cfg
        self.max_len = next_pow2(max_len)
        prompt_cap = next_pow2(prompt_cap or self.max_len // 2)
        if prompt_cap > self.max_len:
            raise ValueError("prompt_cap exceeds max_len")
        super().__init__(n_slots=next_pow2(n_slots), row_cap=prompt_cap,
                         device=resolve_device(device), eos_id=eos_id,
                         feeder_depth=feeder_depth, pipeline_steps=True)
        self.prompt_cap = prompt_cap
        self.eos_id = eos_id
        self.mesh = mesh
        self.params = model.to(self.device)
        self.shards: dict[str, CacheShard] = {}
        self.state = self._init_state()
        self.step_fn = build_step(prompt_cap, self.shards)
        if mesh is not None and mesh.size() > 1:
            self._agree = AdmissionAgreement(self.device)
        # the emitted tokens' two host buffers, each behind an event
        card = self.device.type == "cuda"
        self._host = [torch.empty((self.n_slots,), dtype=torch.int32,
                                  pin_memory=card) for _ in range(2)]
        self._events = ([torch.cuda.Event() for _ in range(2)] if card
                        else None)
        self._flip = 0
        self._logits = None

    # ---------------------------------------------------------------- state
    def _init_state(self) -> dict:
        s, dev = self.n_slots, self.device

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)
        return {
            "cache": self._make_cache(),
            "pos": zeros(s),
            "prompt": zeros(s, self.prompt_cap),
            "prompt_len": zeros(s),
            "last_tok": zeros(s),
            "active": zeros(s, dtype=torch.bool),
            "emitted": torch.full((s,), NO_TOKEN, dtype=torch.int32,
                                  device=dev),
        }

    def _make_cache(self) -> dict:
        """The slot cache; on a mesh this rank's shard of each stack (its
        ``CacheShard`` in ``self.shards``)."""
        if self.mesh is None:
            return make_cache(self.cfg, batch=self.n_slots,
                              max_len=self.max_len, device=self.device)
        whole = make_cache(self.cfg, batch=self.n_slots,
                           max_len=self.max_len, device="meta")
        pls = lm_cache_shardings(self.mesh, whole, seq_sharded=True)
        cache = {}
        for stack, c in whole.items():
            cache[stack] = {
                name: torch.zeros(local_shape(t.shape, self.mesh,
                                              pls[stack][name]),
                                  dtype=t.dtype, device=self.device)
                for name, t in c.items()}
            pl = pls[stack]["k"]
            length, hkv = c["k"].shape[3], c["k"].shape[2]
            s_l, h_l = cache[stack]["k"].shape[3], cache[stack]["k"].shape[2]
            if Shard(3) in pl or Shard(2) in pl:
                self.shards[stack] = CacheShard(
                    length, dp_rank(self.mesh) * s_l if Shard(3) in pl
                    else 0, model_rank(self.mesh) * h_l if Shard(2) in pl
                    else 0, seq_sharded_decode_attn_fn(
                        self.mesh, seq_len=length, kv_heads=hkv))
        return cache

    def _bound_tensors(self) -> dict[str, torch.Tensor]:
        """The model's weights, the cache and the slot state."""
        named = {f"model.{k}": t for k, t in
                 self.params.state_dict(keep_vars=True).items()}
        for stack, c in self.state["cache"].items():
            named.update((f"cache.{stack}.{k}", t) for k, t in c.items())
        named.update((f"state.{k}", t) for k, t in self.state.items()
                     if k != "cache")
        return named

    # ------------------------------------------------------------ admission
    def submit(self, prompt, max_new: int) -> Request:
        """Enqueue one request (thread-safe); returns its Request handle."""
        prompt = [int(t) for t in prompt]
        if not 1 <= len(prompt) <= self.prompt_cap:
            raise ValueError(
                f"prompt length {len(prompt)} not in [1, {self.prompt_cap}]")
        if len(prompt) + max_new > self.max_len:
            raise ValueError(
                f"prompt+max_new {len(prompt) + max_new} exceeds KV bucket "
                f"{self.max_len}")
        bad = [t for t in prompt if not 0 <= t < self.cfg.vocab]
        if bad:
            raise ValueError(f"token ids out of range [0, {self.cfg.vocab})"
                             f": {bad}")
        return self._enqueue(prompt, max_new)

    def _admit_many(self, wave: list) -> None:
        """Seat a wave: [slot, prompt length, prompt row] a request,
        stacked on the host and copied to the device once, then written
        into the state rows (outside the step). The cache needs no
        reset."""
        block = np.empty((len(wave), 2 + self.prompt_cap), np.int32)
        for i, (slot, prep) in enumerate(wave):
            block[i, 0] = slot
            block[i, 1] = prep.request.prompt_len
            block[i, 2:] = prep.row
        dev = torch.from_numpy(block).to(self.device)
        slots = dev[:, 0].to(torch.int64)
        st = self.state
        st["pos"][slots] = 0
        st["prompt"][slots] = dev[:, 2:]
        st["prompt_len"][slots] = dev[:, 1]
        st["last_tok"][slots] = 0
        st["active"][slots] = True

    def _retired(self, slot: int) -> None:
        deactivate_update(self.state, slot)

    # ----------------------------------------------------------------- step
    def _step(self):
        """Run the step; returns its emitted tokens on the CPU, on the card
        a handle: the tokens being copied into a pinned buffer, and the
        event after the copy."""
        self._logits = self._run_step()
        if self._events is None:
            return self.state["emitted"].numpy().copy()
        buf, ev = self._host[self._flip], self._events[self._flip]
        self._flip ^= 1
        buf.copy_(self.state["emitted"], non_blocking=True)
        ev.record()
        return buf, ev

    def _emissions(self, out) -> np.ndarray:
        if isinstance(out, np.ndarray):
            return out
        buf, ev = out
        ev.synchronize()
        return buf.numpy().copy()

    def last_logits(self) -> torch.Tensor | None:
        """The logits [S, V] of the last step launched (on the card valid
        once it has run, and until the next step replays over them)."""
        return self._logits
