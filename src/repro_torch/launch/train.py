"""End-to-end training driver (port of ``repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-9b \
      --smoke --steps 8                 # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-9b \
      --smoke --steps 8 --device cpu    # the kernels' plain twins

Data (``lm_batch`` of (seed, step)) → model → AdamW → checkpoint /
restart through ``train.loop``; ``--fail-at`` crashes the run at a step,
and a second run with the same ``--ckpt-dir`` resumes from the last
commit. GNN and recommender training wait for their slices: ``main``
refuses every arch that is not a language model.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.core.graph import resolve_device
from repro_torch.data import synthetic
from repro_torch.launch.steps import lm_train_step
from repro_torch.models.transformer import LM, LMConfig
from repro_torch.train.loop import (FailureInjector, LoopConfig,
                                    default_ckpt_dir, train)
from repro_torch.train.optim import AdamWConfig, adamw_init


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
    if not isinstance(get_config(args.arch, smoke=args.smoke), LMConfig):
        raise NotImplementedError(
            f"training {args.arch} is not ported yet: GNN training is "
            "ROADMAP.md A10, recommender training A12")
    _, _, history = run_lm(args.arch, args.steps, args.smoke, args.ckpt_dir,
                           args.fail_at, device=args.device)
    for h in history:
        print(h)


if __name__ == "__main__":
    main()
