"""Ranks of a gloo process group for the port's multi-device tests.

``run_ranks(case, inputs, shape, names)`` starts one process a rank
(``python tests/torch_dist_worker.py``), each of which joins a gloo group
through a ``FileStore`` in a fresh directory (no TCP rendezvous), builds a
``DeviceMesh`` of ``shape`` named ``names`` on the CPU, runs
``CASES[case](mesh, inputs)`` and saves what it returns; the parent gets
every rank's result, in rank order. A group that does not finish within
its timeout is killed and the call fails. The ranks import torch, numpy
and ``repro_torch`` only: the reference's side is computed in the parent
and compared there.
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_TIMEOUT_S = 120


def run_ranks(case: str, inputs: dict, shape: tuple[int, ...],
              names: tuple[str, ...], timeout: float = JOIN_TIMEOUT_S
              ) -> list[dict]:
    world = int(np.prod(shape))
    with tempfile.TemporaryDirectory() as d:
        torch.save({"case": case, "inputs": inputs, "shape": tuple(shape),
                    "names": tuple(names)}, os.path.join(d, "in.pt"))
        env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
               "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), d, str(r),
             str(world)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
        deadline = time.monotonic() + timeout
        logs = []
        try:
            for p in procs:
                out, _ = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
                logs.append(out)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            for p in procs:
                p.communicate()
            raise AssertionError(f"{case} at world {world}: no join within "
                                 f"{timeout}s")
        bad = [(r, p.returncode, log) for r, (p, log)
               in enumerate(zip(procs, logs)) if p.returncode]
        assert not bad, "\n".join(f"rank {r} exit {rc}:\n{log[-4000:]}"
                                  for r, rc, log in bad)
        return [torch.load(os.path.join(d, f"out{r}.pt"), weights_only=False)
                for r in range(world)]


# ---------------------------------------------------------------- the cases
def _coo(g):
    from repro_torch.core import graph as tg
    return tg.COO.from_arrays(g["dst"], g["src"], g["n"], capacity=g["cap"],
                              device="cpu")


def _cfg(fields):
    from repro_torch.core.costmodel import EngineConfig
    return EngineConfig(**fields)


def case_shard(mesh, inp):
    """shard_convert and shard_preprocess of every (graph, config); the
    service's preprocess; the keys-only sort."""
    from repro_torch.engine import PreprocService
    from repro_torch.engine.shard import (jit_shard_preprocess,
                                          shard_convert, shard_preprocess,
                                          shard_sort_by_key)
    out = {"convert": [], "preprocess": []}
    for g in inp["graphs"]:
        coo = _coo(g)
        seeds = torch.from_numpy(g["seeds"])
        for fields in inp["cfgs"]:
            cfg = _cfg(fields)
            csc = shard_convert(mesh, coo, cfg)
            out["convert"].append((csc.ptr.numpy(), csc.idx.numpy()))
            sub = shard_preprocess(mesh, coo, seeds, inp["fanouts"],
                                   inp["key"], cfg)
            out["preprocess"].append((sub.csc.ptr.numpy(),
                                      sub.csc.idx.numpy(), sub.order.numpy(),
                                      int(sub.n_sub_nodes)))
    g = inp["graphs"][0]
    svc = PreprocService(inp["fanouts"], mesh=mesh)
    calls = []
    fn = jit_shard_preprocess(mesh)
    assert jit_shard_preprocess(mesh) is fn
    import repro_torch.engine.shard as shard_mod
    real = shard_mod.shard_preprocess

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    shard_mod.shard_preprocess = counted
    jit_shard_preprocess.cache_clear()
    try:
        sub = svc.preprocess(_coo(g), torch.from_numpy(g["seeds"]),
                             inp["key"], cfg=_cfg(inp["cfgs"][0]))
    finally:
        shard_mod.shard_preprocess = real
        jit_shard_preprocess.cache_clear()
    out["service"] = (sub.csc.ptr.numpy(), sub.csc.idx.numpy(),
                      sub.order.numpy(), int(sub.n_sub_nodes), len(calls))
    keys = torch.from_numpy(inp["sort_keys"])
    ks, none = shard_sort_by_key(mesh, keys, None, inp["sort_bound"],
                                 chunk=16)
    out["keys_only"] = (ks.numpy(), none is None)
    return out


def case_decode(mesh, inp):
    """The sequence- and head-sharded decode of each case, on this rank's
    shard of the caches."""
    from repro_torch.dist.collectives import (sharded_decode_attention,
                                              sharded_decode_attention_seq)
    from repro_torch.dist.groups import dp_rank, dp_size, model_rank
    from repro_torch.dist.sharding import model_axis_size
    out = []
    n, msz = dp_size(mesh), model_axis_size(mesh)
    r, mr = dp_rank(mesh), model_rank(mesh)
    for c in inp["cases"]:
        q = torch.from_numpy(c["q"]).to(torch.bfloat16)
        k, v = (torch.from_numpy(c[x]) for x in ("k", "v"))
        lens = torch.from_numpy(c["lens"])
        hkv, s = k.shape[1], k.shape[2]
        head = msz > 1 and hkv % msz == 0
        hs = slice(mr * hkv // msz, (mr + 1) * hkv // msz) if head \
            else slice(None)
        ss = slice(r * s // n, (r + 1) * s // n)
        if c["int8"]:
            k, v = k.to(torch.int8), v.to(torch.int8)
        else:
            k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)

        def shard(sl):
            """k, v and the int8 scales (None for bf16) cut by ``sl``."""
            scales = [torch.from_numpy(c[x])[sl].contiguous()
                      if c["int8"] else None for x in ("k_scale", "v_scale")]
            return k[sl].contiguous(), v[sl].contiguous(), *scales

        kr, vr, ks, vs = shard((slice(None), hs, ss))
        seq = sharded_decode_attention_seq(
            mesh, q, kr, vr, lens, seq_len=s, kv_heads=hkv,
            logit_cap=c["cap"], k_scale=ks, v_scale=vs)
        kr, vr, ks, vs = shard((slice(None), hs))
        headed = sharded_decode_attention(
            mesh, q, kr, vr, lens, kv_heads=hkv, logit_cap=c["cap"],
            k_scale=ks, v_scale=vs)
        out.append((seq.float().numpy(), headed.float().numpy()))
    return out


def case_compress(mesh, inp):
    """compressed_psum_tree of this rank's gradients over the dp group,
    twice (the error buffers carried)."""
    from repro_torch.dist.groups import dp_group, dp_rank
    from repro_torch.train.compress import (compressed_psum_tree,
                                            make_compressed_allreduce,
                                            zeros_like_error)
    r = dp_rank(mesh)
    grads = {name: torch.from_numpy(a[r]).to(
        torch.bfloat16 if name.startswith("bf16") else torch.float32)
        for name, a in inp["grads"].items()}
    errs = zeros_like_error(grads)
    out = []
    for _ in range(2):
        red, errs = compressed_psum_tree(grads, errs, dp_group(mesh))
        out.append(({k: t.float().numpy() for k, t in red.items()},
                    {k: t.numpy() for k, t in errs.items()}))
    fn = make_compressed_allreduce(mesh, None, axis="data")
    red, _ = fn(grads, zeros_like_error(grads))
    out.append({k: t.float().numpy() for k, t in red.items()})
    return out


def case_moe(mesh, inp):
    """moe_apply_local on this rank's tokens under layout(mesh)."""
    from types import SimpleNamespace

    from repro_torch.dist.groups import dp_rank
    from repro_torch.dist.hints import layout
    from repro_torch.models.moe import moe_apply_local
    p = SimpleNamespace(**{k: torch.from_numpy(a)
                           for k, a in inp["w"].items()})
    x = torch.from_numpy(inp["x"][dp_rank(mesh)])
    with layout(mesh):
        y, aux = moe_apply_local(p, x, top_k=inp["top_k"],
                                 capacity_factor=inp["cf"])
    y0, aux0 = moe_apply_local(p, x, top_k=inp["top_k"],
                               capacity_factor=inp["cf"])
    return {"y": y.numpy(), "aux": float(aux), "y_nomesh": y0.numpy(),
            "aux_nomesh": float(aux0)}


def synchronous_polls(feeder_module):
    """Make ``AdmissionFeeder.poll`` wait for the next prepared request
    until the stream is over: admission then depends on the stream alone
    (one schedule for every engine that serves it)."""
    poll = feeder_module.AdmissionFeeder.poll

    def synchronous(self, timeout=None):
        while not self.done:
            got = poll(self, timeout=0.01)
            if got is not None:
                return got
        return None

    feeder_module.AdmissionFeeder.poll = synchronous
    return poll


def case_serve(mesh, inp):
    """The smoke config served on the mesh; the tokens of each request."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import LM
    from repro_torch.serve import feeder
    from repro_torch.serve.engine import ServeEngine
    if inp["synchronous_polls"]:
        synchronous_polls(feeder)
    cfg = get_config(inp["arch"], smoke=True)
    model = LM(cfg, seed=0, device="cpu")
    eng = ServeEngine(cfg, model, n_slots=2, max_len=64, prompt_cap=8,
                      mesh=mesh, device="cpu")
    handles = [eng.submit(p, g) for p, g in inp["reqs"]]
    eng.close_submissions()
    eng.run()
    shards = {k: (s.length, s.pos0, s.head0) for k, s in eng.shards.items()}
    cache = {k: tuple(c["k"].shape) for k, c in eng.state["cache"].items()}
    return {"tokens": [list(h.tokens_out) for h in handles],
            "shards": shards, "cache": cache,
            "steps": eng.stats.steps}


def case_hints(mesh, inp):
    """shard_hint on a DTensor (redistributed) and a plain tensor (the
    same object) under layout(mesh)."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.dist.hints import layout, shard_hint
    x = distribute_tensor(torch.arange(4.0), mesh, [Replicate()])
    plain = torch.arange(4.0)
    with layout(mesh):
        y = shard_hint(x, "dp")
        same = shard_hint(plain, "dp") is plain
    return {"plain_is_same": same, "placements": str(y.placements),
            "local": y.to_local().numpy()}


CASES = {"shard": case_shard, "hints": case_hints, "decode": case_decode,
         "compress": case_compress, "moe": case_moe, "serve": case_serve}


def main(d: str, rank: int, world: int) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.set_num_threads(1)
    spec = torch.load(os.path.join(d, "in.pt"), weights_only=False)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(d, "store"), world), rank=rank, world_size=world)
    mesh = init_device_mesh("cpu", spec["shape"],
                            mesh_dim_names=spec["names"])
    out = CASES[spec["case"]](mesh, spec["inputs"])
    torch.save(out, os.path.join(d, f"out{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
