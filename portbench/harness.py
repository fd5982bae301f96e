"""portbench's cell runner: one cell, one seed, one measured window.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration (``configs/<name>.json``: model, graph, engine) and a traffic
mix (``traffic/<name>.json``, read by ``traffic.py``); its correctness
limits are ``limits/<cell>.json`` and each metric is read by
``metrics/<metric>.py``. Nothing here names a cell, a configuration or a
metric: a new one is new files.

A run: the inputs made on the device from the seed (``reference.graph``),
the program set up on them (its kernels built, the graph converted, the
serve engine warmed up and its step captured), the window, then the
check. The check judges what the window produced against the plain
references under ``reference/``, after the program's state is freed:

* serve cells: the set-up convert's CSC (exact); for a sample of the
  answered requests drawn from the seed (the largest among them), the
  sampled subgraph (exact) and the forward's logits (``logit_err``, the
  widest gap over the reference's largest |logit|) of the program's own
  ``slot_fn`` path run again eagerly under the request's key, and the
  predictions the engine emitted in the window, each of which has to be
  the argmax of those logits (``served_mismatch``, exact: the engine's
  step equals its lanes alone bit for bit);
* convert cells: every version's latest ``ptr`` and ``idx``.

``control=True`` also reads the control: the reference one precision below
the configuration's (matmul operands rounded to TF32) in the program's
place (its ``logit_err``, and for the record the widest gap by which the
class it puts first lies below the reference's best), or for the convert
a CSC ordered by dst alone.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from portbench import tracing, traffic
from portbench.counts import model_counts, peaks
from portbench.counts.preprocess import request_bytes
from portbench.reference import convert as rconvert
from portbench.reference import graph as rgraph
from portbench.reference import models as rmodels
from portbench.reference import prng as rprng
from portbench.reference import sampler as rsampler

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
SENTINEL = 0x7FFFFFFF
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
SLICE_S = 2.0  # the traced slice of a --trace 1 run, after its window
LANES = 3  # requests whose preprocessing and forward are traced alone
TRACED_CONVERTS = 3
BIG = 1e9  # a comparison that found nothing to compare


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    def with_overrides(self, config=None, mix=None) -> "Cell":
        """The same cell with parts of its configuration or mix replaced
        (the tests' small sizes)."""
        return dataclasses.replace(
            self, config=_merge(self.config, config or {}),
            traffic=_merge(self.traffic, mix or {}))


def load_cell(name: str, root: Path = ROOT) -> Cell:
    m = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in m["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"workloads: {sorted(cells)}")
    w = cells[name]
    entry = {c["name"]: c for c in m["configs"]}[w["config"]]
    e2e = [x for x in m["end_to_end"] if name in x.get("workloads", [name])]
    reported = {x["name"] for x in e2e}
    per = [x for x in m["per_layer"]
           if (name in x["workloads"] if "workloads" in x
               else x["moves"] in reported)]
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"],
                config=load_json(root / entry["file"]),
                traffic=load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(BENCH / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=per)


def reader(metric: str):
    """``metrics/<metric>.py``'s ``read(ctx)``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def power_limit_w(index: int) -> float | None:
    """The card's power limit in watts as ``nvidia-smi`` reads it, None
    where it cannot be read; a run reports it beside the peaks."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", str(index)],
            capture_output=True, text=True, timeout=30, check=True)
        return float(r.stdout.strip())
    except (OSError, subprocess.SubprocessError, ValueError):
        return None


def forbidden_modules(names=None) -> list[str]:
    """The top-level names among ``names`` (default: the loaded modules)
    that are JAX's or the JAX package's, each compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({k.split(".")[0] for k in names} & set(FORBIDDEN))


# ------------------------------------------------------------ the program
class Program:
    """The parts of ``repro_torch`` the benchmark drives."""

    def __init__(self):
        from repro_torch.core import costmodel, pipeline, prng
        from repro_torch.core.graph import COO
        from repro_torch.core.sampling import DEFAULT_WINDOW
        from repro_torch.models.gnn import GNNConfig, gnn_model, subgraph_batch
        from repro_torch.serve import GnnServeEngine
        self.costmodel, self.pipeline, self.prng = costmodel, pipeline, prng
        self.COO, self.window = COO, DEFAULT_WINDOW
        self.GNNConfig, self.gnn_model = GNNConfig, gnn_model
        self.subgraph_batch = subgraph_batch
        self.GnnServeEngine = GnnServeEngine

    @staticmethod
    def build_kernels() -> None:
        """Every CUDA source at once (a no-op when all are built)."""
        from repro_torch.kernels import _build
        _build.build()

    def engine_cfg(self, config: dict):
        return getattr(self.costmodel, config["engine"]["cfg"])

    def coo(self, dst, src, graph: dict):
        return self.COO(dst=dst, src=src, n_nodes=graph["n_nodes"],
                        n_edges=torch.tensor(graph["n_edges"],
                                             dtype=torch.int32,
                                             device=dst.device))

    def model(self, cell: Cell, weights: dict, device):
        """The configuration's model (every key of its ``model`` is a
        ``GNNConfig`` field), its weights replaced by ``weights``."""
        m, g = cell.config["model"], cell.config["graph"]
        gcfg = self.GNNConfig(
            name=cell.config_name, sample_sizes=tuple(cell.config["fanouts"]),
            use_pallas_agg=cell.config["engine"].get("use_pallas_agg", False),
            **m)
        model = self.gnn_model(gcfg, g["d_feat"], n_classes=g["n_classes"],
                               generator=torch.Generator().manual_seed(0),
                               device=device)
        params = dict(model.named_parameters())
        if set(params) != set(weights):
            raise RuntimeError(f"the model's parameters {sorted(params)} are "
                               f"not the configuration's {sorted(weights)}")
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(weights[k])
        return model


# ------------------------------------------------------------ helpers
def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak(dev) -> int:
    return int(torch.cuda.max_memory_reserved(dev)) if dev.type == "cuda" \
        else 0


def _free(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _mismatch(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        return max(a.numel(), b.numel())
    return int((a.to(b.device) != b).sum())


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    if got.shape != want.shape:
        return BIG
    scale = float(want.abs().max().clamp(min=1e-30))
    return float((got.to(want.device) - want).abs().max()) / scale


def _gap(ref: torch.Tensor, chosen: torch.Tensor) -> float:
    """The widest gap, over rows, by which the chosen class's reference
    logit lies below the row's best, as a share of the row's largest
    |logit|."""
    best = ref.max(dim=1).values
    at = ref.gather(1, chosen.to(torch.int64)[:, None])[:, 0]
    scale = ref.abs().max(dim=1).values.clamp(min=1e-30)
    return float(((best - at) / scale).max())


def _row(seeds: list, cap: int, dev) -> torch.Tensor:
    row = torch.full((cap,), SENTINEL, dtype=torch.int32)
    row[:len(seeds)] = torch.tensor(seeds, dtype=torch.int32)
    return row.to(dev)


def _sample(records: list, k: int, seed: int) -> list:
    """``k`` answered requests drawn from the seed, half of them the
    largest."""
    if len(records) <= k:
        return list(records)
    rng = np.random.default_rng([int(seed), 6])
    by_size = sorted(records, key=lambda r: -r.n_seeds)
    top = by_size[:k // 2]
    rest = by_size[k // 2:]
    pick = rng.choice(len(rest), k - len(top), replace=False)
    return top + [rest[i] for i in sorted(pick)]


def _inputs_graph(config: dict, seed: int, dev, version: int = 0):
    g = config["graph"]
    return rgraph.power_law_coo(
        g["n_nodes"], g["n_edges"], g["capacity"], g["dst_alpha"],
        rgraph.generator(seed, "graph", dev, version), dev)


# ------------------------------------------------------------ the runs
class _Laps:
    """Seconds of each set-up phase, each closed by a synchronise."""

    def __init__(self, dev):
        self.dev, self.laps, self.t = dev, {}, time.perf_counter()

    def __call__(self, name: str) -> None:
        _sync(self.dev)
        now = time.perf_counter()
        self.laps[name] = now - self.t
        self.t = now


class Ctx:
    """What the metric readers read (``metrics/*.py``)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def answered_in_window(self) -> list:
        w = self.window
        return [r for r in w.records if r.done is not None and r.done <= w.t_end]

    def idle_pct(self):
        if self.trace is None or self.trace["window_s"] <= 0:
            return None
        return 100.0 * (1.0 - self.trace["busy_s"] / self.trace["window_s"])


class Served:
    """A serve cell's inputs and its warmed program."""

    def __init__(self, cell: Cell, P: Program, seed: int, dev):
        cfg, mix = cell.config, cell.traffic
        g, eng = cfg["graph"], cfg["engine"]
        lap = _Laps(dev)
        self.fanouts = tuple(cfg["fanouts"])
        self.key_seed = int(seed) % 2 ** 31
        self.dst, self.src = _inputs_graph(cfg, seed, dev)
        self.feats = rgraph.features(g["n_nodes"], g["d_feat"],
                                     rgraph.generator(seed, "features", dev),
                                     dev)
        self.weights = rgraph.weights(
            rmodels.param_specs(cfg["model"], g["d_feat"], g["n_classes"]),
            rgraph.generator(seed, "weights", dev), dev)
        lap("inputs")
        self.ecfg = P.engine_cfg(cfg)
        self.csc = P.pipeline.convert(P.coo(self.dst, self.src, g), self.ecfg,
                                      device=dev)
        lap("convert")
        self.model = P.model(cell, self.weights, dev)
        self.engine = P.GnnServeEngine(
            self.model, self.csc, self.feats, fanouts=self.fanouts,
            n_slots=eng["n_slots"], seed_cap=eng["seed_cap"], cfg=self.ecfg,
            key_seed=self.key_seed, device=dev)
        warm = traffic.RequestPlan(mix, g["n_nodes"], self.engine.seed_cap,
                                   seed ^ 0x5EED)
        lap("engine")
        traffic.warm_up(self.engine, warm, 2 * self.engine.n_slots)
        lap("warm_up")
        self.laps = lap.laps

    def plan(self, mix: dict, n_nodes: int, seed: int) -> traffic.RequestPlan:
        return traffic.RequestPlan(mix, n_nodes, self.engine.seed_cap, seed)


def _serve(cell: Cell, P: Program, seed: int, seconds: float, trace: bool,
           dev, control: bool, t_start: float) -> dict:
    cfg = cell.config
    g, eng = cfg["graph"], cfg["engine"]
    sv = Served(cell, P, seed, dev)
    fanouts, key_seed, ecfg = sv.fanouts, sv.key_seed, sv.ecfg
    dst, src, feats, w = sv.dst, sv.src, sv.feats, sv.weights
    csc, model, engine = sv.csc, sv.model, sv.engine
    plan = sv.plan(cell.traffic, g["n_nodes"], seed)
    laps = sv.laps
    del sv
    win = traffic.serve_window(engine, plan, seconds)
    setup_s = win.t0 - t_start
    peak = _peak(dev)
    tracer = None
    if trace and dev.type == "cuda":  # the traced slice, a window of its own
        tracer = tracing.Slice(SLICE_S)
        engine.reopen()
        win.failed += traffic.serve_window(engine, plan, 0.0, tracer).failed

    # the program's side of the check: each sampled request's subgraph
    # and logits through the path every slot runs, under its own key
    answered = [r for r in win.records if r.done is not None]
    sample = _sample(answered, int(cell.limits["sample_requests"]), seed)
    outs, lanes = [], {"preprocess": [], "forward": []}
    sub = logits = None
    for i, r in enumerate(sample):
        row = _row(r.seeds, engine.seed_cap, dev)
        sched = P.prng.key_schedule(engine.request_key(r.handle.rid), fanouts,
                                    ecfg.selection, P.window).to(dev)
        with torch.inference_mode():
            sub = P.pipeline.sample_subgraph(csc, row, fanouts, sched, ecfg)
            logits = model(P.subgraph_batch(sub, feats))
            if tracer is not None and i < LANES:
                lanes["preprocess"].append(tracing.device_ms(
                    lambda: P.pipeline.sample_subgraph(csc, row, fanouts,
                                                       sched, ecfg),
                    "portbench.preprocess"))
                lanes["forward"].append(tracing.device_ms(
                    lambda: model(P.subgraph_batch(sub, feats)),
                    "portbench.forward"))
        n_u = int(sub.n_sub_nodes)
        outs.append(dict(order=sub.order, n_unique=n_u, ptr=sub.csc.ptr,
                         idx=sub.csc.idx, n_edges=int(sub.csc.n_edges),
                         logits=logits[:n_u].float()))
    prog_ptr, prog_idx = csc.ptr, csc.idx
    del engine, model, csc, sub, logits
    _free(dev)

    # the reference's side
    checks = {"failed_requests": win.failed}
    ref_ptr, ref_idx = rconvert.csc(dst, src, g["n_nodes"])
    checks["csc_mismatch"] = (_mismatch(prog_ptr, ref_ptr)
                              + _mismatch(prog_idx, ref_idx))
    del prog_ptr, prog_idx, dst, src
    _free(dev)
    sub_mis, served_mis, errs, sizes = 0, 0, [0.0], []
    ctrl_errs, ctrl_gaps = [], []
    counts = model_counts(cfg["model"]["kind"])
    root = rprng.root_key(key_seed)
    for r, got in zip(sample, outs):
        row = _row(r.seeds, eng["seed_cap"], dev)
        s = rsampler.sample(ref_ptr, ref_idx, g["n_nodes"], row, fanouts,
                            rprng.fold_in(root, r.handle.rid))
        sub_mis += (_mismatch(got["order"], s["order"])
                    + _mismatch(got["ptr"], s["ptr"])
                    + _mismatch(got["idx"], s["idx"])
                    + abs(got["n_edges"] - s["n_edges"])
                    + abs(got["n_unique"] - s["n_unique"]))
        x = feats[s["order"][:s["n_unique"]].to(torch.int64)]
        ref = rmodels.forward(cfg["model"], w, x, s["edge_dst"], s["edge_src"])
        errs.append(_rel_err(got["logits"], ref))
        served = torch.tensor(r.handle.tokens_out, dtype=torch.int64)
        if (served.numel() != r.n_seeds or served.numel() == 0
                or int(served.min()) < 0 or int(served.max()) >= ref.shape[1]):
            checks["failed_requests"] += 1
        else:
            own = got["logits"][:r.n_seeds].argmax(dim=1).cpu()
            served_mis += int((own != served).sum())
        if control:
            c = rmodels.forward(cfg["model"], w, x, s["edge_dst"],
                                s["edge_src"], tf32=True)
            ctrl_errs.append(_rel_err(c, ref))
            ctrl_gaps.append(_gap(ref[:r.n_seeds],
                                  c[:r.n_seeds].argmax(dim=1)))
        sizes.append(dict(
            n_seeds=s["n_seeds"], frontier_live=s["frontier_live"],
            n_edges=s["n_edges"], n_unique=s["n_unique"],
            flops=counts.forward_flops(cfg["model"], g["d_feat"],
                                       g["n_classes"], s["n_unique"],
                                       s["n_edges"]),
            bytes=request_bytes(s["n_seeds"], s["frontier_live"],
                                s["n_edges"], s["n_unique"])))
        del s, x, ref
    checks["subgraph_mismatch"] = sub_mis
    checks["logit_err"] = max(errs)
    checks["served_mismatch"] = served_mis
    ctx = Ctx(kind="serve", seconds=seconds, setup_s=setup_s, window=win,
              trace=tracer.summary() if tracer is not None else None,
              lanes=lanes, sizes=sizes, peaks=peaks(), config=cfg,
              convert_device_ms=[])
    out = dict(ctx=ctx, checks=checks, peak=peak,
               attempted=len(win.records), failed=checks["failed_requests"],
               extra=dict(late_p99_ms=win.late_p99_ms,
                          checked_requests=len(sample), setup_laps=laps))
    if control:
        out["control"] = dict(logit_err=max(ctrl_errs, default=0.0),
                              served_gap=max(ctrl_gaps, default=0.0))
    return out


def _convert(cell: Cell, P: Program, seed: int, seconds: float, trace: bool,
             dev, control: bool, t_start: float) -> dict:
    cfg, g = cell.config, cell.config["graph"]
    lap = _Laps(dev)
    ecfg = P.engine_cfg(cfg)
    graphs = [_inputs_graph(cfg, seed, dev, v)
              for v in range(int(cell.traffic["versions"]))]
    versions = [P.coo(d, s, g) for d, s in graphs]
    lap("inputs")

    def convert(coo):
        return P.pipeline.convert(coo, ecfg, device=dev)

    for coo in versions[:2]:
        convert(coo)
        _sync(dev)
    lap("warm_up")
    tracer = tracing.Slice(SLICE_S) if trace and dev.type == "cuda" else None
    win, outs = traffic.convert_window(convert, versions, seconds,
                                       lambda: _sync(dev), tracer)
    setup_s = win.t0 - t_start
    peak = _peak(dev)
    dev_ms = ([tracing.device_ms(lambda: convert(versions[0]),
                                 "portbench.convert")
               for _ in range(TRACED_CONVERTS)] if tracer is not None else [])
    del versions
    _free(dev)
    mis, ctrl = 0, 0
    for (d, s), out in zip(graphs, outs):
        if out is None:
            continue
        ptr, idx = rconvert.csc(d, s, g["n_nodes"])
        mis += _mismatch(out.ptr, ptr) + _mismatch(out.idx, idx)
        mis += abs(int(out.n_edges) - g["n_edges"])
        if control:
            cp, ci = rconvert.dst_only_csc(d, s, g["n_nodes"])
            ctrl += _mismatch(cp, ptr) + _mismatch(ci, idx)
            del cp, ci
        del ptr, idx
        _free(dev)
    checks = {"failed_converts": 0, "csc_mismatch": mis}
    ctx = Ctx(kind="convert", seconds=seconds, setup_s=setup_s, window=win,
              trace=tracer.summary() if tracer is not None else None,
              lanes={"preprocess": [], "forward": []}, sizes=[],
              peaks=peaks(), config=cfg, convert_device_ms=dev_ms)
    out = dict(ctx=ctx, checks=checks, peak=peak, attempted=win.converts,
               failed=0, extra=dict(converts=win.converts,
                                    setup_laps=lap.laps,
                                    versions_checked=sum(
                                        o is not None for o in outs)))
    if control:
        out["control"] = dict(csc_mismatch=ctrl)
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float | None = None, control: bool = False) -> dict:
    """One run of ``cell``; returns the result line's object (and, with
    ``control``, the control's readings under ``"control"``)."""
    t_start = time.perf_counter() if t_start is None else t_start
    t_imports = time.perf_counter() - t_start
    dev = torch.device(device)
    if cell.config.get("precision") != "float32":
        raise ValueError("the configurations state float32")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    P = Program()
    if dev.type == "cuda":
        t_build = time.perf_counter()
        P.build_kernels()
        torch.zeros(1, device=dev)  # the context, before its statistics
        torch.cuda.reset_peak_memory_stats(dev)
        t_build = time.perf_counter() - t_build
    run = _convert if cell.traffic["loop"] == "convert" else _serve
    got = run(cell, P, seed, seconds, trace, dev, control, t_start)
    ctx = got["ctx"]
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    limits = cell.limits["limits"]
    checks = {k: {"value": float(v), "limit": float(limits[k])}
              for k, v in got["checks"].items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
              "count": 1, "memory_peak_bytes": got["peak"]}
    out = {"correct": bool(correct), "attempted": int(got["attempted"]),
           "failed": int(got["failed"]), "metrics": metrics,
           "device": device}
    if trace and ctx.trace is not None:
        device["busy_s"] = ctx.trace["busy_s"]
        device["window_s"] = ctx.trace["window_s"]
        out["breakdown"] = {"device_ops": ctx.trace["device_ops"],
                            "idle_gaps": ctx.trace["idle_gaps"]}
    out["run"] = dict(got["extra"], seed=int(seed), seconds=seconds,
                      trace=bool(trace))
    if dev.type == "cuda":
        out["run"]["setup_laps"] = dict(
            imports=t_imports, build_and_cuda_init=t_build,
            **out["run"]["setup_laps"])
        out["run"]["peaks"] = ctx.peaks
        out["run"]["power_limit_w"] = power_limit_w(dev.index or 0)
    if "control" in got:
        out["control"] = got["control"]
    out["checks"] = checks
    return out


def check_lines(result: dict) -> list[str]:
    return [f"check {k}: {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}"
            for k, c in result["checks"].items()]


def percentile(xs: list, q: float) -> float:
    """The nearest-rank ``q``-quantile (0 < q <= 1)."""
    xs = sorted(xs)
    return xs[max(0, math.ceil(q * len(xs)) - 1)]


def median(xs: list):
    return statistics.median(xs) if xs else None
