"""End-to-end training driver (port of ``repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch graphsage-reddit
                                        # sampled GNN training on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch graphsage-reddit \
      --smoke --steps 8 --device cpu    # the kernels' plain twins
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-9b \
      --smoke --steps 8                 # LM training (any LM config)
  PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm-rm2 \
      --smoke --device cpu              # recommender training

Data → (GNN: the preprocessing engine samples a subgraph a step;
recommender: the batch's lookups sorted into their transposed layout) →
model → AdamW → checkpoint / restart through ``train.loop``;
``--fail-at`` crashes the run at a step, and a second run with the same
``--ckpt-dir`` resumes from the last commit.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs import get_arch, get_config
from repro_torch.core.graph import COO, resolve_device
from repro_torch.data import synthetic
from repro_torch.data.sampler import SampledDataset
from repro_torch.launch.steps import (gnn_train_step, lm_train_step,
                                      recsys_train_step)
from repro_torch.models.dlrm import DLRM
from repro_torch.models.gnn import GNNConfig, gnn_model
from repro_torch.models.transformer import LM
from repro_torch.train.loop import (FailureInjector, LoopConfig,
                                    default_ckpt_dir, train)
from repro_torch.train.optim import AdamWConfig, adamw_init

# (nodes, edges, features, classes, batch): the smoke graph, and Reddit's
GNN_DATA = {True: (512, 4096, 32, 7, 32),
            False: (232_965, 114_615_892, 602, 41, 1024)}


def gnn_data(seed: int, smoke: bool):
    """``synthetic.graph_dataset`` at ``run_gnn``'s size: (dst, src,
    features, labels) as numpy arrays."""
    n_nodes, n_edges, d_feat, n_classes, _ = GNN_DATA[smoke]
    return synthetic.graph_dataset(seed, n_nodes, n_edges, d_feat,
                                   n_classes)


def regression_targets(batch, d_out: int):
    """``batch`` with its labels one-hot in ``d_out`` float32 columns (a
    label at or past ``d_out`` gives a zero row): MeshGraphNet's
    regression targets, as the reference's ``run_gnn`` makes them."""
    classes = torch.arange(d_out, device=batch.labels.device)
    return dataclasses.replace(batch, labels=(
        batch.labels[:, None] == classes).to(torch.float32))


def run_gnn(arch: str, steps: int, smoke: bool, ckpt_dir: str | None,
            fail_at: int | None, seed: int = 0, device="cuda", data=None,
            log_every: int = 10):
    """Train GNN ``arch`` for ``steps`` steps on a synthetic graph (512
    nodes, 4,096 edges, 32 features, 7 classes, batch 32 with ``smoke``;
    else Reddit's 232,965 nodes, 114,615,892 edges, 602 features, 41
    classes, batch 1024), sampled by ``SampledDataset`` at the config's
    fanouts (or (5, 3)) a step ahead (``prefetch``), AdamW at lr 1e-3,
    checkpointing every max(steps // 4, 10) steps into ``ckpt_dir``
    (default ``train.loop.default_ckpt_dir()``) and resuming from it.
    MeshGraphNet regresses onto the labels one-hot in ``d_out`` columns.
    ``data`` is ``gnn_data(seed, smoke)`` already built. Returns (model,
    AdamW state, metrics history)."""
    cfg: GNNConfig = get_config(arch, smoke=smoke)
    n_nodes, _, d_feat, n_classes, batch = GNN_DATA[smoke]
    fanouts = cfg.sample_sizes or (5, 3)
    dev = resolve_device(device)
    dst, src, feats, labels = gnn_data(seed, smoke) if data is None else data
    ds = SampledDataset(
        coo=COO.from_arrays(dst, src, n_nodes, device=dev),
        features=torch.from_numpy(feats).to(dev),
        labels=torch.from_numpy(labels).to(dev),
        fanouts=fanouts, batch_size=batch, seed=seed)
    node_reg = cfg.kind == "meshgraphnet"
    model = gnn_model(cfg, d_feat, d_edge=4,
                      n_classes=0 if node_reg else n_classes,
                      generator=torch.Generator().manual_seed(seed),
                      device=dev)
    opt_cfg = AdamWConfig(lr=1e-3)
    opt = adamw_init(dict(model.named_parameters()))

    def step_fn(model, opt, batch):
        if node_reg:
            batch = regression_targets(batch, cfg.d_out)
        return model, opt, gnn_train_step(model, opt_cfg, opt, batch)

    loop_cfg = LoopConfig(total_steps=steps, ckpt_every=max(steps // 4, 10),
                          ckpt_dir=ckpt_dir or default_ckpt_dir(),
                          log_every=log_every, prefetch=True)
    return train(loop_cfg, step_fn, model, opt, ds.batch,
                 failure=FailureInjector(fail_at))


def run_lm(arch: str, steps: int, smoke: bool, ckpt_dir: str | None,
           fail_at: int | None, seed: int = 0, device="cuda",
           prefetch: bool = False):
    """Train ``arch`` for ``steps`` steps (4 × 64 tokens with ``smoke``,
    else the reference's 256 × 4,096), checkpointing into ``ckpt_dir``
    (default ``train.loop.default_ckpt_dir()``) and resuming from it;
    ``prefetch`` makes each batch a step ahead (on a side CUDA stream on
    the card). Returns (model, AdamW state, metrics history)."""
    cfg = get_config(arch, smoke=smoke)
    batch, seq = (4, 64) if smoke else (256, 4096)
    dev = resolve_device(device)
    model = LM(cfg, seed=seed, device=dev)
    opt_cfg = AdamWConfig(lr=3e-4)
    opt = adamw_init(dict(model.named_parameters()))

    def step_fn(model, opt, tokens):
        return model, opt, lm_train_step(model, opt_cfg, opt, tokens)

    def batch_fn(step):
        return torch.from_numpy(synthetic.lm_batch(seed, step, batch, seq,
                                                   cfg.vocab)).to(dev)

    loop_cfg = LoopConfig(total_steps=steps, ckpt_every=max(steps // 4, 10),
                          ckpt_dir=ckpt_dir or default_ckpt_dir(),
                          prefetch=prefetch)
    return train(loop_cfg, step_fn, model, opt, batch_fn,
                 failure=FailureInjector(fail_at))


def run_recsys(arch: str, steps: int, smoke: bool, ckpt_dir: str | None,
               fail_at: int | None, seed: int = 0, device="cuda",
               vocab_size: int | None = None, log_every: int = 10):
    """Train recommender ``arch`` for ``steps`` steps on ``dlrm_batch``
    batches (64 with ``smoke``, else 65,536), AdamW at lr 1e-3,
    checkpointing every max(steps // 4, 10) steps into ``ckpt_dir``
    (default ``train.loop.default_ckpt_dir()``) and resuming from it;
    ``vocab_size`` cuts the tables' rows (the indices clip into the cut).
    Returns (model, AdamW state, metrics history)."""
    cfg = get_config(arch, smoke=smoke)
    if vocab_size is not None:
        cfg = dataclasses.replace(cfg, vocab_size=vocab_size)
    batch = 64 if smoke else 65536
    dev = resolve_device(device)
    model = DLRM(cfg, seed=seed, device=dev)
    opt_cfg = AdamWConfig(lr=1e-3)
    opt = adamw_init(dict(model.named_parameters()))

    def step_fn(model, opt, batch):
        return model, opt, recsys_train_step(model, opt_cfg, opt, batch)

    def batch_fn(step):
        return tuple(torch.from_numpy(a).to(dev) for a in synthetic.dlrm_batch(
            seed, step, batch, cfg.n_dense, cfg.n_sparse, cfg.hot,
            cfg.vocab_size))

    loop_cfg = LoopConfig(total_steps=steps, ckpt_every=max(steps // 4, 10),
                          ckpt_dir=ckpt_dir or default_ckpt_dir(),
                          log_every=log_every)
    return train(loop_cfg, step_fn, model, opt, batch_fn,
                 failure=FailureInjector(fail_at))


RUNNERS = {"gnn": run_gnn, "lm": run_lm, "recsys": run_recsys}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: repro_torch_ckpt under $TMPDIR")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a crash at this step (chaos drill)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    runner = RUNNERS[get_arch(args.arch).family]
    _, _, history = runner(args.arch, args.steps, args.smoke, args.ckpt_dir,
                           args.fail_at, device=args.device)
    for h in history:
        print(h)


if __name__ == "__main__":
    main()
