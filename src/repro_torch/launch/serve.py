"""GNN serving driver — a thin CLI over ``repro_torch.serve.GnnServeEngine``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch graphsage-reddit
  PYTHONPATH=src python -m repro_torch.launch.serve --arch graphsage-reddit \
      --smoke --device cpu --engine-cfg merge

``--arch`` is any registered GNN arch (graphsage-reddit, gat-cora,
gatedgcn, meshgraphnet); the model is built by ``models.gnn.gnn_model``.
The engine samples with the config's ``sample_sizes``: gat-cora, gatedgcn
and meshgraphnet have none, so, as in the reference's CLI, the engine
raises for them.

Builds a synthetic power-law graph on the device (``--nodes`` nodes,
``--edges`` edges), converts it, and submits ``--requests`` requests of
mixed seed counts in [1, ``--seed-cap``] to a GnnServeEngine with random
weights made from ``--seed``. The preprocessing runs under the
hand-written kernels, in one of two engine configurations
(``--engine-cfg``):

* ``slice`` (``SLICE_CFG``): ``global_radix`` sorts through the digit-pass
  kernels, the fused rank epilogue through the rank kernels;
* ``merge`` (``MERGE_CFG``): ``chunked_merge`` sorts through the
  chunk-sort and fused-merge kernels, the unfused pointer build through
  the set-count kernel, and the model's aggregation through the
  segment-sum kernel (``use_pallas_agg``).

On ``--device cpu`` the same routing runs the kernels' plain twins. Prints
the predictions, predictions/s and request latency.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import pipeline
from repro_torch.core.costmodel import EngineConfig
from repro_torch.core.graph import next_pow2, resolve_device, synthetic_coo
from repro_torch.models.gnn import gnn_model
from repro_torch.serve import GnnServeEngine

SLICE_CFG = EngineConfig(use_pallas=True, sort_strategy="global_radix",
                         reindex_strategy="fused")
MERGE_CFG = EngineConfig(use_pallas=True, sort_strategy="chunked_merge",
                         reindex_strategy="unfused")
# --engine-cfg → (engine configuration, GNNConfig.use_pallas_agg)
ENGINE_CFGS = {"slice": (SLICE_CFG, False), "merge": (MERGE_CFG, True)}


def percentile(xs: list[float], q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(len(xs) * q))]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
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
    engine_cfg, pallas_agg = ENGINE_CFGS[args.engine_cfg]
    cfg = dataclasses.replace(get_config(args.arch, smoke=args.smoke),
                              use_pallas_agg=pallas_agg)
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
