"""The serve CLI — a thin front over the port's serve engines.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b \
      --smoke --device cpu --requests 6
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch granite-moe-1b-a400m --slots 8 --max-len 1024 --prompt-len 512
  PYTHONPATH=src python -m repro_torch.launch.serve --arch graphsage-reddit
  PYTHONPATH=src python -m repro_torch.launch.serve --arch graphsage-reddit \
      --smoke --device cpu --engine-cfg merge

LM archs (gemma2-9b, granite-moe-1b-a400m, codeqwen1.5-7b, qwen1.5-32b,
grok-1-314b; the last two do not fit one card at full depth) submit
``--requests`` random-token requests of mixed
prompt lengths in [1, ``--prompt-len``] and budgets in [1, ``--gen``]
(from ``--seed + 1``) to a ``ServeEngine`` (continuous batching over
``--slots`` slots, a KV cache of ``--max-len`` positions, the step
captured once as a CUDA graph on the card) with random weights made from
``--seed``; it prints each request's tokens, tokens/s (processed and
generated), admission latency p50/p99 and the captured step programs. A
mesh (the reference's sequence-sharded cache) is ROADMAP.md A.9.

GNN archs (graphsage-reddit, gat-cora, gatedgcn, meshgraphnet; the model
is built by ``models.gnn.gnn_model``) serve on a ``GnnServeEngine``: the
engine samples with the config's ``sample_sizes``, and gat-cora, gatedgcn
and meshgraphnet have none, so, as in the reference's CLI, the engine
raises for them. It builds a synthetic power-law graph on the device
(``--nodes`` nodes, ``--edges`` edges), converts it, and submits
``--requests`` requests of mixed seed counts in [1, ``--seed-cap``] with
random weights made from ``--seed``. The preprocessing runs under the
hand-written kernels, in one of two engine configurations
(``--engine-cfg``):

* ``slice`` (``SLICE_CFG``): ``global_radix`` sorts through the digit-pass
  kernels, the fused rank epilogue through the rank kernels;
* ``merge`` (``MERGE_CFG``): ``chunked_merge`` sorts through the
  chunk-sort and fused-merge kernels, the unfused pointer build through
  the set-count kernel, and the model's aggregation through the
  segment-sum kernel (``use_pallas_agg``).

It prints the predictions, predictions/s and request latency. On
``--device cpu`` the same routing runs the kernels' plain twins.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import pipeline
from repro_torch.core.costmodel import MERGE_CFG, SLICE_CFG
from repro_torch.core.graph import next_pow2, resolve_device, synthetic_coo
from repro_torch.models.gnn import gnn_model
from repro_torch.models.transformer import LM, LMConfig
from repro_torch.serve import GnnServeEngine, ServeEngine

# --engine-cfg → (engine configuration, GNNConfig.use_pallas_agg)
ENGINE_CFGS = {"slice": (SLICE_CFG, False), "merge": (MERGE_CFG, True)}


def percentile(xs: list[float], q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(len(xs) * q))]


def _make_lm_engine(cfg: LMConfig, args, dev) -> ServeEngine:
    model = LM(cfg, seed=args.seed, device=dev)
    return ServeEngine(cfg, model, n_slots=args.slots,
                       max_len=args.max_len, prompt_cap=args.prompt_len,
                       device=dev)


def _serve_lm(cfg: LMConfig, args, dev) -> None:
    eng = _make_lm_engine(cfg, args, dev)
    rng = np.random.default_rng(args.seed + 1)
    t0 = time.perf_counter()
    for _ in range(args.requests):
        plen = int(rng.integers(1, args.prompt_len + 1))
        gen = int(rng.integers(1, args.gen + 1))
        eng.submit(rng.integers(0, cfg.vocab, plen).tolist(), gen)
    eng.close_submissions()
    completed = eng.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0

    for req in sorted(completed, key=lambda r: r.rid):
        print(f"req{req.rid}: prompt_len={req.prompt_len} "
              f"gen={req.tokens_out}")
    lat = [r.admission_latency_s for r in completed]
    print(f"{eng.stats.tokens_processed / dt:.1f} tok/s processed, "
          f"{eng.stats.tokens_generated / dt:.1f} tok/s generated over "
          f"{len(completed)} requests ({eng.stats.steps} steps, "
          f"{eng.step_cache_size()} step program(s), "
          f"{dt:.2f}s total, device {dev})")
    print(f"admission latency p50={percentile(lat, 0.5) * 1e3:.2f}ms "
          f"p99={percentile(lat, 0.99) * 1e3:.2f}ms")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128,
                    help="LM: KV cache positions")
    ap.add_argument("--prompt-len", type=int, default=16,
                    help="LM: max prompt length; actual lengths are mixed")
    ap.add_argument("--gen", type=int, default=32,
                    help="LM: max new tokens; actual budgets are mixed")
    ap.add_argument("--nodes", type=int, default=1024)
    ap.add_argument("--edges", type=int, default=None,
                    help="default: 6 × nodes")
    ap.add_argument("--features", type=int, default=16)
    ap.add_argument("--classes", type=int, default=8)
    ap.add_argument("--seed-cap", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--engine-cfg", choices=sorted(ENGINE_CFGS),
                    default="slice")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if isinstance(cfg, LMConfig):
        _serve_lm(cfg, args, dev)
        return
    engine_cfg, pallas_agg = ENGINE_CFGS[args.engine_cfg]
    cfg = dataclasses.replace(cfg, use_pallas_agg=pallas_agg)
    edges = args.edges or 6 * args.nodes
    coo = synthetic_coo(args.nodes, edges, next_pow2(edges), args.seed,
                        device=dev)
    csc = pipeline.convert(coo, engine_cfg, device=dev)
    g = torch.Generator().manual_seed(args.seed)
    feats = torch.randn((args.nodes, args.features), generator=g)
    model = gnn_model(cfg, d_in=args.features, n_classes=args.classes,
                      generator=g, device=dev)
    eng = GnnServeEngine(model, csc, feats, n_slots=args.slots,
                         seed_cap=args.seed_cap, cfg=engine_cfg, device=dev)
    rng = np.random.default_rng(args.seed + 1)
    t0 = time.perf_counter()
    for _ in range(args.requests):
        k = int(rng.integers(1, args.seed_cap + 1))
        eng.submit(rng.choice(args.nodes, k, replace=False).tolist())
    eng.close_submissions()
    completed = eng.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0

    for req in sorted(completed, key=lambda r: r.rid):
        print(f"req{req.rid}: seeds={req.prompt_len} preds={req.tokens_out}")
    lat = [r.total_latency_s for r in completed]
    print(f"{eng.stats.tokens_generated / dt:.1f} pred/s over "
          f"{len(completed)} requests ({eng.stats.steps} steps, "
          f"{dt:.2f}s total, device {dev})")
    print(f"request latency p50={percentile(lat, 0.5) * 1e3:.2f}ms "
          f"p99={percentile(lat, 0.99) * 1e3:.2f}ms")
    print(f"kernel launches {eng.kernel_launches()}")


if __name__ == "__main__":
    main()
