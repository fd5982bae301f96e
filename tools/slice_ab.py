#!/usr/bin/env python3
"""Compare trees of this repository on one card, in turns, on the port's
SLICE_CFG serve path: what a request costs end to end and what the rank
epilogue's five calls cost on the arrays the path hands them; or, with
``--what kernels``, what the chunk sort, the filter, the merge ladder's
kernels and a MERGE_CFG convert cost; with ``--what digit``, what the
global_radix digit pass, its whole sort and a SLICE_CFG convert cost;
with ``--what serve``, what serving costs under both configurations; or,
with ``--what scan``, what the pointer segment sum costs on the serve
path's own pointers; with ``--what segsum``, what the dst-sorted
segment sum and the prefix partition cost; with ``--what decode``,
what the decode attention kernel costs; or, with ``--what plain``, what
the plain path (``use_pallas`` off) costs where GNN training and the
kernels' twins run it.

  python3 tools/slice_ab.py --tree parent=build/ab/parent --tree change=. \\
      --order parent,change,change,parent \\
      [--what kernels|digit|serve|scan|segsum|decode|plain]

A tree is the root of a checkout (unpack an earlier commit with
``git archive`` into a directory that ``.gitignore`` lists). Each turn is
one process with that tree's ``src`` first on ``sys.path``: it builds the
tree's slice-path kernels (into the tree's own ``build/``), makes
``chip_smoke.py``'s Reddit-scale graph, features and GraphSAGE from
``--seed``, converts under SLICE_CFG and builds a ``GnnServeEngine``, then

- times ``--reps`` rounds of ``slot_fn`` over chip_smoke's request seeds
  (host clock, a synchronise before and after each request: the request's
  wall time, host launches included), and one request of the largest
  under ``torch.profiler`` (the rank kernels' device time by name);
- captures the five rank-epilogue calls of one convert and of the largest
  request (``chip_smoke.rank_calls_of_the_path``) and times the tree's
  ``rank_search`` / ``rename`` wrapper and ``torch.searchsorted`` on them,
  queued behind a device sleep (device time) and not (the host's cost),
  checking the wrapper's result against ``torch.searchsorted``.

``--what kernels`` instead times, queued behind a device sleep, the
tree's ``chunk_sort`` wrapper (pairs and keys, chunk 4096) at a request's
2^19 elements (19-bit keys) and at the MERGE_CFG convert's 2^27 (18-bit
keys), each checked against a per-chunk stable ``torch.sort``; its
``filter_tree_lookup`` wrapper at ``chip_smoke.FILTER_TIMED`` (unique
keys, a quarter of the targets hit), checked against
``torch.searchsorted`` on the sorted keys; its ``fused_merge_rounds``
wrapper (runs 4096 → 65,536, pairs and keys) at 2^19 and 2^27 and one
rung above it (65,536 → 131,072, pairs: the tree's ``merge_rung``, or
the plain rung ``ordering.merge_ladder`` where the tree has none), each
checked against a per-block stable ``torch.sort``; and the host-clock
seconds of a MERGE_CFG convert of chip_smoke's Reddit-scale COO (the
median of three after a warm-up).

``--what digit`` times, queued behind a device sleep, the tree's
global_radix digit pass at the SLICE_CFG convert's 2^27 pairs (keys
uniform in [0, 232,965]): one 4-bit and one 7-bit pass (``digit_pass``,
the histogram + scan + scatter, where the tree has it, else its
``global_digit_pass``) and the tree's ``digit_hist`` alone where it has
one, each checked against a stable ``torch.sort`` by
the digit; the whole 18-bit sort as SLICE_CFG routes it
(``ordering.stable_sort_by_key`` with the tree's ``kernel_fns``), checked
against the torch.sort strategy; and the host-clock seconds of a SLICE_CFG convert
of chip_smoke's Reddit-scale COO (the median of three after a warm-up).

``--what serve`` serves chip_smoke's 16 mixed-size requests (after its
warm-up request) through the tree's ``GnnServeEngine`` under SLICE_CFG
and under MERGE_CFG with ``use_pallas_agg``, both on the SLICE_CFG
convert of chip_smoke's Reddit-scale graph: predictions/s, p50/p99
request latency, steps, the step programs the engine built (where the
tree counts them); then each of the 16 requests alone (submitted, served
and read before the next: light traffic, one slot busy), their p50/p99
latency; and the peak memory allocated and reserved over the engine's
life.

``--what scan`` converts chip_smoke's Reddit-scale graph under SLICE_CFG,
samples one request of 1,024 seeds at fanouts 15-10 and one at 25-10
(``subgraph_batch``: the pointers the forward hands the pointer sum) and
times, queued behind a device sleep, the tree's ``ptr_seg_sum`` on a
message stream of the path's shape ([E, D], N(0, 1) from ``--seed``) over
those pointers: at 15-10 for D 1, 8, 64, 70 and 128 (the GAT, GatedGCN
and MeshGraphNet widths), at 25-10 for D 602; GraphSAGE's whole pointer
aggregation of a request's layer 1 as the tree's forward computes it
(``models.gnn._ptr_seg_sum`` through ``edge_src`` where the tree's takes
``rows``, else ``seg_mean(batch, gather_src(batch, h))``); and
chip_smoke's synthetic cases (every row in a segment at [524288, 602];
one span of 2^17 rows at D 1 and 602). Each result is held against a
float64 sum of the same rows.

``--what segsum`` converts and samples as ``--what scan`` does and times,
queued behind a device sleep, the tree's dst-sorted segment sum
(``segment_sum_sorted``) on the same requests' ``edge_dst``: the message
streams at 15-10 for D 1, 8, 70 and 128; GraphSAGE's ``MERGE_CFG``
aggregation of both layers (D 602 and 128) as the tree's forward computes
it (``models.gnn._dst_seg_sum`` through ``edge_src`` with the mean where
the tree has it, else ``seg_mean(batch, gather_src(batch, h), True)``);
and chip_smoke's synthetic stream (``SERVE_EDGES`` live edges sorted over
``SERVE_NODES`` rows, a SENTINEL tail to 2^19) at D 602 and 1; beside
them the tree's ``ptr_seg_sum`` on the same spans (its time and a
checksum of its bits: the header move must keep both); and
``prefix_partition`` at 2^24 values, blocks 1024, 96, 1000 and 4100.

``--what decode`` times, queued behind a device sleep, the tree's
``decode_attention`` wrapper at gemma2-9b's heads (16 over 8, dh 256), a
bf16 q and cap 50, on an int8 cache quantized from N(0, 1) drawn from
``--seed``, at three shapes (``DECODE_SHAPES``): (a) the LM serve slice's
cache (8 slots, 1,024 positions) at the live lengths a stream left in
it, (b) decode_32k's length, 8 x 32,768 live, (c) a full local ring, 8 x
4,096 live; beside each, its bound (the live rows' int8 bytes and
scales, q, out), ``scaled_dot_product_attention`` on the dequantized
bf16 cache (a boolean mask, no cap: a near function), a checksum of the
output's bits, and its share of the tree's ``twin_tolerance`` against
the twin (on the first slot only at 32k); and the tree's split kernel's
registers, stack and spills (``cuobjdump --dump-resource-usage``).

``--what plain`` times, queued behind a device sleep, the twins whose
times chip_smoke prints as ``plain_ms`` at its request shape (``SERVE_CAP``
pairs of keys below ``SERVE_NODES``): ``digit_hist`` and ``digit_scatter``
(7 bits), the chunk sort (chunk 4096), the fused merge's ladder (runs 4096
→ 65,536) and one rung above it (``ordering.merge_ladder``), each checked
against a stable ``torch.sort``; chip_smoke's Reddit-scale COO converted
under ``SLICE_CFG`` and ``MERGE_CFG`` with ``use_pallas`` off (the plain
global_radix and chunked_merge paths), checked against the torch.sort
strategy; and graphsage-reddit's training at full size as
``launch.train.run_gnn`` builds it (``SampledDataset`` on Reddit's
synthetic graph, the config the service picks, its convert timed), its
steps (a batch made and one AdamW step) timed on the host clock after
two warm-up steps, the median of ``PLAIN_TRAIN_STEPS``.

Each turn prints one JSON line; the whole run also goes to
``chiprun_out/slice_ab.json``. Needs a card; the trees' timings are
comparable only within one run.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# kernels of the rank epilogue (and the digit pass's rank_gather_kernel)
# in a trace, by the names of this tree's and earlier trees' kernels
RANK_KERNELS = r"(?:rank|rename)\w*_kernel(?:<\w+>)?"
# (name, cache positions, live lengths) of --what decode; (a) the lengths
# chip_smoke's 16-request LM serve stream left in its 8 x 1,024 cache
DECODE_SHAPES = (("slice", 1024, (79, 112, 206, 389, 444, 326, 495, 260)),
                 ("decode_32k", 32768, (32768,) * 8),
                 ("ring_4096", 4096, (4096,) * 8))


def turn(tree: str, seed: int, n_requests: int, reps: int) -> dict:
    """One tree's readings, in this process."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs  # its helpers; it puts ROOT/src on sys.path
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import numpy as np
    import torch
    from repro_torch.configs.graphsage_reddit import config
    from repro_torch.core import pipeline
    from repro_torch.core.graph import synthetic_coo
    from repro_torch.kernels import _build
    from repro_torch.kernels import reindex_epilogue as tre
    from repro_torch.launch.serve import SLICE_CFG
    from repro_torch.models.gnn import GraphSAGE
    from repro_torch.serve import GnnServeEngine

    import repro_torch
    assert repro_torch.__file__.startswith(os.path.abspath(tree)), (
        repro_torch.__file__, tree)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(("digit_pass", "reindex_epilogue"))
    coo = synthetic_coo(cs.REDDIT["nodes"], cs.REDDIT["edges"],
                        cs.CONVERT_CAP, seed, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    feats = torch.randn((cs.REDDIT["nodes"], cs.REDDIT["feats"]),
                        generator=g, device=dev)
    model = GraphSAGE(config(), d_in=cs.REDDIT["feats"],
                      n_classes=cs.REDDIT["classes"],
                      generator=torch.Generator().manual_seed(seed + 2),
                      device=dev)
    csc = pipeline.convert(coo, SLICE_CFG, device=dev)
    eng = GnnServeEngine(model, csc, feats, n_slots=cs.N_SLOTS,
                         seed_cap=cs.SEED_CAP, cfg=SLICE_CFG, device=dev)
    # chip_smoke's draws: one warm-up request of 16 seeds, then the timed
    rng = np.random.default_rng(seed)
    rng.choice(cs.REDDIT["nodes"], 16, replace=False)
    reqs = [rng.choice(cs.REDDIT["nodes"], int(k), replace=False).tolist()
            for k in rng.integers(1, cs.SEED_CAP + 1, n_requests)]
    rows = [cs.seed_row(eng, s) for s in reqs]
    keys = [eng.request_key(i) for i in range(n_requests)]
    for row, key in zip(rows, keys):  # warm-up: cuBLAS, allocator pools
        eng.slot_fn(eng.params, row, key)
    torch.cuda.synchronize()
    request_ms = []
    for _ in range(reps):
        for row, key in zip(rows, keys):
            t0 = time.perf_counter()
            eng.slot_fn(eng.params, row, key)
            torch.cuda.synchronize()
            request_ms.append((time.perf_counter() - t0) * 1e3)
    big = max(range(n_requests), key=lambda i: len(reqs[i]))
    prof = cs.profile_call(lambda: eng.slot_fn(eng.params, rows[big],
                                               keys[big]),
                           kernels=RANK_KERNELS)

    calls = {}
    for name, (arr, qs, side, table) in cs.rank_calls_of_the_path(
            dev, coo, eng, reqs[big], big).items():
        if table is None:
            def kernel():
                return tre.rank_search(arr, qs, side)
        else:
            def kernel():
                return tre.rename(arr, table, qs)

        def library():
            return torch.searchsorted(arr, qs, side=side or "left",
                                      out_int32=True)
        rank = library()
        want = rank if table is None else torch.where(
            (rank < arr.numel()) & (qs != 0x7FFFFFFF)
            & (arr[rank.clamp(max=arr.numel() - 1)] == qs),
            table[rank.clamp(max=arr.numel() - 1)],
            torch.full_like(rank, 0x7FFFFFFF))
        cs.check(torch.equal(kernel(), want),
                 f"{tree} {name}: the wrapper == torch.searchsorted")
        calls[name] = dict(
            queries=qs.numel(), stream=arr.numel(),
            ms=cs.cuda_ms(kernel), library_ms=cs.cuda_ms(library),
            unqueued_ms=cs.cuda_ms(kernel, queued=False),
            library_unqueued_ms=cs.cuda_ms(library, queued=False))
    srt = sorted(request_ms)
    return dict(tree=tree, requests=n_requests, reps=reps,
                request_ms_median=srt[len(srt) // 2],
                request_ms_mean=sum(srt) / len(srt),
                round_ms=[sum(request_ms[i:i + n_requests])
                          for i in range(0, len(request_ms), n_requests)],
                profile=dict(wall_ms=prof["wall_ms"],
                             device_ms=prof["device_ms"],
                             kernels=prof["kernels"]),
                rank_calls=calls)


PLAIN_TRAIN_STEPS = 6


def turn_plain(tree: str, seed: int) -> dict:
    """One tree's plain-path readings, in this process."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import ordering, pipeline
    from repro_torch.core.graph import COO, synthetic_coo
    from repro_torch.data.sampler import SampledDataset
    from repro_torch.kernels import radix_sort as trs
    from repro_torch.launch.serve import MERGE_CFG, SLICE_CFG
    from repro_torch.launch.steps import gnn_train_step
    from repro_torch.launch.train import GNN_DATA, gnn_data
    from repro_torch.models.gnn import gnn_model
    from repro_torch.train.optim import AdamWConfig, adamw_init

    import repro_torch
    assert repro_torch.__file__.startswith(os.path.abspath(tree)), (
        repro_torch.__file__, tree)
    dev = torch.device("cuda", 0)
    out = {}
    g = torch.Generator(device=dev).manual_seed(seed + 10)
    n, bound = cs.SERVE_CAP, cs.SERVE_NODES
    keys = torch.full((n,), bound, dtype=torch.int32, device=dev)
    keys[:cs.SERVE_EDGES] = torch.randint(0, bound, (cs.SERVE_EDGES,),
                                          generator=g, device=dev,
                                          dtype=torch.int32)
    vals = torch.arange(n, dtype=torch.int32, device=dev)
    key_bits = bound.bit_length()

    def stable(k, v, block, shift=0, width=32):
        o = torch.sort(((k >> shift) & ((1 << width) - 1) if width < 32
                        else k).view(-1, block), dim=1, stable=True).indices
        return (k.view(-1, block).gather(1, o).reshape(-1),
                v.view(-1, block).gather(1, o).reshape(-1))

    tile = trs.SCATTER_TILE
    offs = trs.digit_offsets(trs._digit_hist_plain(keys, 7, tile, 7))
    got = trs._digit_scatter_plain(keys, vals, offs, 7, tile, 7)
    want = stable(keys, vals, n, 7, 7)
    cs.check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
             f"{tree}: the digit_scatter twin == a stable torch.sort")
    out["digit_hist_plain_ms"] = cs.cuda_ms(
        lambda: trs._digit_hist_plain(keys, 7, tile, 7), iters=5)
    out["digit_scatter_plain_ms"] = cs.cuda_ms(
        lambda: trs._digit_scatter_plain(keys, vals, offs, 7, tile, 7),
        iters=3)

    def chunk():
        return ordering._chunk_sort(keys, vals, cs.TILE, key_bits,
                                    cs.RADIX_BITS)
    ks, vs = chunk()
    want = stable(keys, vals, cs.TILE)
    cs.check(torch.equal(ks, want[0]) and torch.equal(vs, want[1]),
             f"{tree}: the chunk sort twin == a stable torch.sort")
    out["chunk_sort_plain_ms"] = cs.cuda_ms(chunk, iters=3, warmup=1)
    top = 65536
    fans = [2] * ((top // cs.TILE).bit_length() - 1)
    fk, fv = ordering.merge_ladder(ks, vs, cs.TILE, fans)
    want = stable(keys, vals, top)
    cs.check(torch.equal(fk, want[0]) and torch.equal(fv, want[1]),
             f"{tree}: the fused merge's ladder == a stable torch.sort")
    out["fused_merge_plain_ms"] = cs.cuda_ms(
        lambda: ordering.merge_ladder(ks, vs, cs.TILE, fans), iters=3,
        warmup=1)
    rk, rv = ordering.merge_ladder(fk, fv, top, [2])
    want = stable(keys, vals, 2 * top)
    cs.check(torch.equal(rk, want[0]) and torch.equal(rv, want[1]),
             f"{tree}: one plain rung == a stable torch.sort")
    out["merge_rung_plain_ms"] = cs.cuda_ms(
        lambda: ordering.merge_ladder(fk, fv, top, [2]), iters=3, warmup=1)
    del keys, vals, offs, got, want, ks, vs, fk, fv, rk, rv

    coo = synthetic_coo(cs.REDDIT["nodes"], cs.REDDIT["edges"],
                        cs.CONVERT_CAP, seed, device=dev)
    base = pipeline.convert_xla(coo, device=dev) if hasattr(
        pipeline, "convert_xla") else pipeline.convert(
        coo, dataclasses.replace(SLICE_CFG, use_pallas=False,
                                 sort_strategy="xla_sort"), device=dev)
    for tag, cfg in (("slice", SLICE_CFG), ("merge", MERGE_CFG)):
        cfg = dataclasses.replace(cfg, use_pallas=False)
        csc = pipeline.convert(coo, cfg, device=dev)
        cs.check(torch.equal(csc.ptr, base.ptr)
                 and torch.equal(csc.idx, base.idx),
                 f"{tree}: the plain {tag} convert == the torch.sort one")
        del csc
        torch.cuda.reset_peak_memory_stats()
        out[f"plain_{tag}_convert_ms"] = cs.cuda_ms(
            lambda cfg=cfg: pipeline.convert(coo, cfg, device=dev), iters=2,
            warmup=1)
        out[f"plain_{tag}_convert_peak_gib"] = (
            torch.cuda.max_memory_allocated() / 2**30)
    del coo, base
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    dst, src, feats, labels = gnn_data(seed, False)
    out["train_data_host_s"] = time.perf_counter() - t0
    n_nodes, _, d_feat, n_classes, batch_size = GNN_DATA[False]
    cfg = get_config("graphsage-reddit")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = SampledDataset(coo=COO.from_arrays(dst, src, n_nodes, device=dev),
                        features=torch.from_numpy(feats).to(dev),
                        labels=torch.from_numpy(labels).to(dev),
                        fanouts=cfg.sample_sizes, batch_size=batch_size,
                        seed=seed)
    torch.cuda.synchronize()
    out["train_dataset_s"] = time.perf_counter() - t0
    out["train_engine_cfg"] = ds.engine_cfg.key
    out["train_convert_ms"] = cs.cuda_ms(
        lambda: pipeline.convert(ds.coo, ds.engine_cfg, device=dev),
        iters=2, warmup=1)
    model = gnn_model(cfg, d_feat, d_edge=4, n_classes=n_classes,
                      generator=torch.Generator().manual_seed(seed),
                      device=dev)
    opt_cfg = AdamWConfig(lr=1e-3)
    opt = adamw_init(dict(model.named_parameters()))
    secs, losses = [], []
    for i in range(2 + PLAIN_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = gnn_train_step(model, opt_cfg, opt, ds.batch(i))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    timed = sorted(secs[2:])
    out["train_step_ms_median"] = 1e3 * timed[len(timed) // 2]
    out["train_step_ms"] = [1e3 * t for t in secs]
    out["train_losses"] = losses
    return dict(tree=tree, **out)


def turn_kernels(tree: str, seed: int) -> dict:
    """One tree's chunk-sort, filter, merge and MERGE_CFG convert
    readings, in this process."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import torch
    from repro_torch.core import ordering, pipeline
    from repro_torch.core.graph import synthetic_coo
    from repro_torch.kernels import _build
    from repro_torch.kernels import merge as tm
    from repro_torch.kernels import radix_sort as trs
    from repro_torch.kernels import set_count as tsc
    from repro_torch.launch.serve import MERGE_CFG

    import repro_torch
    assert repro_torch.__file__.startswith(os.path.abspath(tree)), (
        repro_torch.__file__, tree)
    dev = torch.device("cuda", 0)
    _build.build(("digit_pass", "set_count", "merge"))
    g = torch.Generator(device=dev).manual_seed(seed + 10)
    out = dict(chunk_sort={}, filter={}, merge={})
    for n, bound in ((cs.SERVE_CAP, cs.SERVE_NODES),
                     (cs.CHUNK_SORT_BIG, cs.REDDIT["nodes"])):
        keys = torch.randint(0, bound, (n,), generator=g, device=dev,
                             dtype=torch.int32)
        vals = torch.arange(n, dtype=torch.int32, device=dev)
        st = torch.sort(keys.view(-1, cs.TILE), dim=1, stable=True)
        for v in (vals, None):
            def kernel():
                return trs.chunk_sort(keys, v, cs.TILE, bound.bit_length(),
                                      cs.RADIX_BITS)
            got = kernel()
            cs.check(torch.equal(got[0], st.values.view(-1)) and (
                v is None or torch.equal(got[1], st.indices.view(-1).int()
                                         + torch.arange(
                                             0, n, cs.TILE, device=dev,
                                             dtype=torch.int32
                                         ).repeat_interleave(cs.TILE))),
                     f"{tree} chunk_sort {n}: == per-chunk torch.sort")
            del got
            out["chunk_sort"][f"{n} {'pairs' if v is not None else 'keys'}"
                              ] = cs.cuda_ms(kernel)
        del keys, vals, st
    for e, t in cs.FILTER_TIMED:
        keys = torch.randperm(10 * e, generator=g, device=dev)[:e].to(
            torch.int32)
        pays = torch.arange(e, dtype=torch.int32, device=dev)
        tgts = torch.randint(0, 10 * e, (t,), generator=g, device=dev,
                             dtype=torch.int32)
        tgts[:t // 4] = keys[torch.randint(0, e, (t // 4,), generator=g,
                                           device=dev)]
        sk, order = torch.sort(keys)
        i = torch.clamp(torch.searchsorted(sk, tgts), max=e - 1)
        hit = sk[i] == tgts
        want = torch.where(hit, pays[order][i], -1)

        def kernel():
            return tsc.filter_tree_lookup(keys, pays, tgts)
        got = kernel()
        cs.check(torch.equal(got[0], want) and torch.equal(got[1], hit),
                 f"{tree} filter_tree_lookup {e} x {t}: == searchsorted")
        out["filter"][f"{e} keys x {t} targets"] = cs.cuda_ms(
            kernel, iters=20 if e * t <= cs.FILTER_TWIN_TIMED else 5)
    block = tm.DEFAULT_MAX_BLOCK
    for n, bound in ((cs.SERVE_CAP, cs.SERVE_NODES),
                     (cs.CHUNK_SORT_BIG, cs.REDDIT["nodes"])):
        keys = torch.sort(torch.randint(
            0, bound, (n,), generator=g, device=dev, dtype=torch.int32
        ).view(-1, cs.TILE), dim=1).values.view(-1)
        vals = torch.arange(n, dtype=torch.int32, device=dev)
        for v in (vals, None):
            def fused():
                return tm.fused_merge_rounds(keys, v, cs.TILE)
            st = torch.sort(keys.view(-1, block), dim=1, stable=True)
            got = fused()
            cs.check(torch.equal(got[0], st.values.view(-1)) and (
                v is None or torch.equal(got[1], v.view(-1, block).gather(
                    1, st.indices).view(-1))),
                f"{tree} fused_merge_rounds {n}: == per-block torch.sort")
            out["merge"][f"fused {n} {'pairs' if v is not None else 'keys'}"
                         ] = cs.cuda_ms(fused)
            del got, st
        rk = tm.fused_merge_rounds(keys, vals, cs.TILE)[:2]
        rung = getattr(tm, "merge_rung", None)
        label = "rung" if rung is not None else "plain rung"

        def upper():
            if rung is not None:
                return rung(rk[0], rk[1], block, 2)
            return ordering.merge_ladder(rk[0], rk[1], block, [2])
        st = torch.sort(rk[0].view(-1, 2 * block), dim=1, stable=True)
        got = upper()
        cs.check(torch.equal(got[0], st.values.view(-1)) and torch.equal(
            got[1], rk[1].view(-1, 2 * block).gather(1, st.indices).view(-1)),
            f"{tree} {label} {n}: == per-block torch.sort")
        out["merge"][f"{label} {n} pairs"] = cs.cuda_ms(
            upper, iters=20 if rung is not None else 3)
        del keys, vals, rk, st, got
    coo = synthetic_coo(cs.REDDIT["nodes"], cs.REDDIT["edges"],
                        cs.MERGE_CONVERT_CAP, seed + 5, device=dev)
    secs = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipeline.convert(coo, MERGE_CFG, device=dev)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    out["merge_convert_s"] = sorted(secs[1:])[1]
    out["merge_convert_all_s"] = secs
    return dict(tree=tree, **out)


def turn_digit(tree: str, seed: int) -> dict:
    """One tree's digit-pass, sort and SLICE_CFG convert readings, in this
    process."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import torch
    from repro_torch.core import ordering, pipeline
    from repro_torch.core.graph import synthetic_coo
    from repro_torch.kernels import _build
    from repro_torch.kernels import radix_sort as trs
    from repro_torch.launch.serve import SLICE_CFG

    import repro_torch
    assert repro_torch.__file__.startswith(os.path.abspath(tree)), (
        repro_torch.__file__, tree)
    dev = torch.device("cuda", 0)
    _build.build(("digit_pass", "reindex_epilogue"))
    g = torch.Generator(device=dev).manual_seed(seed + 11)
    n, bound = cs.CONVERT_CAP, cs.REDDIT["nodes"]
    keys = torch.randint(0, bound + 1, (n,), generator=g, device=dev,
                         dtype=torch.int32)
    vals = torch.arange(n, dtype=torch.int32, device=dev)
    out = {}
    for width in (4, 7):
        def one_pass():
            if hasattr(trs, "digit_pass"):
                return trs.digit_pass(keys, vals, width, width)
            return trs.global_digit_pass(keys, vals, width, cs.TILE, width)
        got = one_pass()
        order = torch.sort((keys >> width) & ((1 << width) - 1),
                           stable=True).indices
        cs.check(torch.equal(got[0], keys[order])
                 and torch.equal(got[1], vals[order]),
                 f"{tree} {width}-bit pass: == a stable torch.sort")
        del got, order
        out[f"pass_{width}bit_pairs_ms"] = cs.cuda_ms(one_pass, iters=5)
        if hasattr(trs, "digit_hist"):
            out[f"hist_{width}bit_ms"] = cs.cuda_ms(
                lambda: trs.digit_hist(keys, width, trs.SCATTER_TILE, width),
                iters=5)
    kf = pipeline.kernel_fns(SLICE_CFG)

    def sort():
        return ordering.stable_sort_by_key(
            keys, vals, bound, chunk=SLICE_CFG.w_upe, strategy="global_radix",
            **pipeline._sort_kwargs(SLICE_CFG, kf, kf.chunk_sort_fn))
    got = sort()
    want = ordering.xla_stable_sort_by_key(keys, vals, bound)
    cs.check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
             f"{tree} global_radix sort: == the torch.sort strategy")
    del got, want
    out["sort_18bit_pairs_ms"] = cs.cuda_ms(sort, iters=3)
    del keys, vals
    coo = synthetic_coo(cs.REDDIT["nodes"], cs.REDDIT["edges"],
                        cs.CONVERT_CAP, seed + 5, device=dev)
    secs = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipeline.convert(coo, SLICE_CFG, device=dev)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    out["slice_convert_s"] = sorted(secs[1:])[1]
    out["slice_convert_all_s"] = secs
    return dict(tree=tree, **out)


def turn_serve(tree: str, seed: int, n_requests: int) -> dict:
    """One tree's serve readings under both engine configurations, in
    this process."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs.graphsage_reddit import config
    from repro_torch.core import pipeline
    from repro_torch.core.graph import synthetic_coo
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import ENGINE_CFGS, percentile
    from repro_torch.models.gnn import GraphSAGE
    from repro_torch.serve import GnnServeEngine

    import repro_torch
    assert repro_torch.__file__.startswith(os.path.abspath(tree)), (
        repro_torch.__file__, tree)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    coo = synthetic_coo(cs.REDDIT["nodes"], cs.REDDIT["edges"],
                        cs.CONVERT_CAP, seed, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    feats = torch.randn((cs.REDDIT["nodes"], cs.REDDIT["feats"]),
                        generator=g, device=dev)
    csc = pipeline.convert(coo, ENGINE_CFGS["slice"][0], device=dev)
    del coo
    out = {}
    for path, (cfg, pallas_agg) in ENGINE_CFGS.items():
        model = GraphSAGE(
            dataclasses.replace(config(), use_pallas_agg=pallas_agg),
            d_in=cs.REDDIT["feats"], n_classes=cs.REDDIT["classes"],
            generator=torch.Generator().manual_seed(seed + 2), device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        eng = GnnServeEngine(model, csc, feats, n_slots=cs.N_SLOTS,
                             seed_cap=cs.SEED_CAP, cfg=cfg, device=dev)
        rng = np.random.default_rng(seed)  # chip_smoke's draws
        eng.submit(rng.choice(cs.REDDIT["nodes"], 16, replace=False).tolist())
        eng.close_submissions()
        eng.run()
        torch.cuda.synchronize()
        eng.reopen()
        reqs = [rng.choice(cs.REDDIT["nodes"], int(k), replace=False).tolist()
                for k in rng.integers(1, cs.SEED_CAP + 1, n_requests)]
        steps = eng.stats.steps
        t0 = time.perf_counter()
        for r in reqs:
            eng.submit(r)
        eng.close_submissions()
        done = eng.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        lat = [r.total_latency_s for r in done]
        lone = []  # each request alone: light traffic, one slot busy
        for r in reqs:
            eng.reopen()
            eng.submit(r)
            eng.close_submissions()
            lone += [q.total_latency_s for q in eng.run()]
            torch.cuda.synchronize()
        cache = getattr(eng, "step_cache_size", None)
        out[path] = dict(
            preds_per_s=sum(map(len, reqs)) / dt, wall_s=dt,
            p50_ms=percentile(lat, 0.5) * 1e3,
            p99_ms=percentile(lat, 0.99) * 1e3,
            lone_p50_ms=percentile(lone, 0.5) * 1e3,
            lone_p99_ms=percentile(lone, 0.99) * 1e3,
            steps=eng.stats.steps - steps,
            step_programs=cache() if cache else None,
            peak_over_start_gib=(torch.cuda.max_memory_allocated() - base)
            / 2**30,
            peak_gib=torch.cuda.max_memory_allocated() / 2**30,
            peak_reserved_gib=torch.cuda.max_memory_reserved() / 2**30)
        del eng, model
        torch.cuda.empty_cache()
    return dict(tree=tree, **out)


def turn_scan(tree: str, seed: int) -> dict:
    """One tree's pointer segment sum readings, in this process."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.core import pipeline, prng
    from repro_torch.core.graph import synthetic_coo
    from repro_torch.kernels import _build
    from repro_torch.kernels import ptr_scan
    from repro_torch.launch.serve import SLICE_CFG
    from repro_torch.models import gnn as tgnn

    import repro_torch
    assert repro_torch.__file__.startswith(os.path.abspath(tree)), (
        repro_torch.__file__, tree)
    dev = torch.device("cuda", 0)
    _build.build()
    coo = synthetic_coo(cs.REDDIT["nodes"], cs.REDDIT["edges"],
                        cs.CONVERT_CAP, seed, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    feats = torch.randn((cs.REDDIT["nodes"], cs.REDDIT["feats"]),
                        generator=g, device=dev)
    csc = pipeline.convert(coo, SLICE_CFG, device=dev)
    del coo
    rng = np.random.default_rng(seed)
    seeds = torch.from_numpy(rng.choice(cs.REDDIT["nodes"], cs.SEED_CAP,
                                        replace=False).astype(np.int32))
    batches = {f: tgnn.subgraph_batch(pipeline.sample_subgraph(
        csc, seeds.to(dev), f, prng.PRNGKey(seed), SLICE_CFG), feats)
        for f in ((15, 10), (25, 10))}

    def exact(ptr, msgs):
        p = ptr.to(torch.int64)
        c = F.pad(torch.cumsum(msgs.double(), 0), (0, 0, 1, 0))
        return c.index_select(0, p[1:]) - c.index_select(0, p[:-1])

    def reading(ptr, msgs):
        got = ptr_scan.ptr_seg_sum(ptr, msgs)
        err = float((got.double() - exact(ptr, msgs)).abs().max())
        return dict(ms=cs.cuda_ms(lambda: ptr_scan.ptr_seg_sum(ptr, msgs)),
                    shape=list(msgs.shape), rows_out=ptr.shape[0] - 1,
                    ptr_end=int(ptr[-1]), vs_float64=err)

    out = {}
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    for f, widths in (((15, 10), (1, 8, 64, 70, 128)), ((25, 10), (602,))):
        b = batches[f]
        e = b.edge_src.shape[0]
        ptr = torch.clamp(b.ptr, 0, e).to(torch.int32)
        for d in widths:
            msgs = torch.randn((e, d), generator=gen, device=dev)
            out[f"fanout{f[0]}_d{d}"] = reading(ptr, msgs)
            del msgs
    b = batches[(25, 10)]
    h = b.node_feat
    if "rows" in inspect.signature(tgnn._ptr_seg_sum).parameters:
        def agg():
            return tgnn._ptr_seg_sum(b.ptr, h, b.edge_src, True)
    else:
        def agg():
            return tgnn.seg_mean(b, tgnn.gather_src(b, h))
    e = b.edge_src.shape[0]
    msgs = torch.where(tgnn._valid(b)[:, None], tgnn.gather_src(b, h), 0.0)
    want = exact(torch.clamp(b.ptr, 0, e), msgs) / (
        b.ptr[1:] - b.ptr[:-1]).clamp(min=1).double()[:, None]
    out["graphsage_layer1_mean"] = dict(
        ms=cs.cuda_ms(agg), vs_float64=float((agg().double() - want).abs()
                                             .max()))
    del msgs, want, batches, b, h
    for key in ("full_stream", "long_d1", "long_wide"):
        e, d, n, kind = cs.SCAN_CASES[key]
        ptr, msgs = cs.scan_case(dev, seed + e + d, e, d, n, kind)
        out[key] = reading(ptr, msgs)
        del ptr, msgs
    torch.cuda.empty_cache()
    return dict(tree=tree, **out)


def turn_segsum(tree: str, seed: int) -> dict:
    """One tree's dst-sorted segment sum, pointer segment sum and prefix
    partition readings, in this process."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import numpy as np
    import torch
    from repro_torch.core import pipeline, prng
    from repro_torch.core.graph import synthetic_coo
    from repro_torch.kernels import _build, ptr_scan
    from repro_torch.kernels import prefix_partition as tpp
    from repro_torch.kernels import segment_agg as tsa
    from repro_torch.launch.serve import SLICE_CFG
    from repro_torch.models import gnn as tgnn

    import repro_torch
    assert repro_torch.__file__.startswith(os.path.abspath(tree)), (
        repro_torch.__file__, tree)
    dev = torch.device("cuda", 0)
    _build.build(("segment_agg", "ptr_scan", "prefix_partition"))
    fused = "rows" in inspect.signature(tsa.segment_sum_sorted).parameters
    coo = synthetic_coo(cs.REDDIT["nodes"], cs.REDDIT["edges"],
                        cs.CONVERT_CAP, seed, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    feats = torch.randn((cs.REDDIT["nodes"], cs.REDDIT["feats"]),
                        generator=g, device=dev)
    csc = pipeline.convert(coo, SLICE_CFG, device=dev)
    del coo
    rng = np.random.default_rng(seed)
    seeds = torch.from_numpy(rng.choice(cs.REDDIT["nodes"], cs.SEED_CAP,
                                        replace=False).astype(np.int32))
    batches = {f: tgnn.subgraph_batch(pipeline.sample_subgraph(
        csc, seeds.to(dev), f, prng.PRNGKey(seed), SLICE_CFG), feats)
        for f in ((15, 10), (25, 10))}
    del csc

    def bits(t):
        return int(t.view(torch.int32).to(torch.int64).sum())

    def exact(dst, x, n, rows, mean):
        msgs = x if rows is None else x.index_select(
            0, rows.clamp(0, x.shape[0] - 1))
        out = torch.zeros((n + 1, x.shape[1]), dtype=torch.float64,
                          device=dev).index_add_(
            0, dst.clamp(max=n).long(), msgs.double())[:n]
        if mean:
            cnt = torch.bincount(dst[dst < n].long(), minlength=n)
            out = out / cnt.clamp(min=1).double()[:, None]
        return out

    def reading(dst, x, n, rows=None, mean=False, agg=None):
        if agg is None:
            def agg():
                return (tsa.segment_sum_sorted(dst, x, n, rows, mean) if fused
                        else tsa.segment_sum_sorted(dst, x, n))
        got = agg()
        ptr = torch.searchsorted(dst, torch.arange(n + 1, dtype=torch.int32,
                                                   device=dev),
                                 out_int32=True)

        def spans():
            return ptr_scan.ptr_seg_sum(ptr, x, rows, mean)
        r = dict(ms=cs.cuda_ms(agg), shape=list(x.shape), rows_out=n,
                 live=int((dst < n).sum()),
                 vs_float64=float((got.double() - exact(dst, x, n, rows, mean))
                                  .abs().max()),
                 ptr_seg_sum_ms=cs.cuda_ms(spans), ptr_seg_sum_bits=bits(
                     spans()))
        r["equals_ptr_seg_sum"] = bool(torch.equal(got, spans()))
        return r

    out = {}
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    b = batches[(15, 10)]
    n = b.n_nodes
    for d in (1, 8, 70, 128):
        msgs = torch.randn((b.edge_dst.shape[0], d), generator=gen,
                           device=dev)
        out[f"fanout15_d{d}"] = reading(b.edge_dst, msgs, n)
        del msgs
    b = batches[(25, 10)]
    n = b.n_nodes
    for layer, h in (("layer1", b.node_feat),
                     ("layer2", torch.randn((n, 128), generator=gen,
                                            device=dev))):
        bb = tgnn.GraphBatch(edge_dst=b.edge_dst, edge_src=b.edge_src,
                             node_feat=h)
        if fused:
            def agg(bb=bb, h=h):
                return tgnn._dst_seg_sum(bb, h, bb.edge_src, True)
        else:
            def agg(bb=bb, h=h):
                return tgnn.seg_mean(bb, tgnn.gather_src(bb, h), True)
        out[f"graphsage_merge_{layer}"] = reading(
            b.edge_dst, h.contiguous(), n, b.edge_src.contiguous(), True, agg)
    del batches, b, bb, h
    # chip_smoke's synthetic stream: SERVE_EDGES live edges over
    # SERVE_NODES rows, a SENTINEL tail to SERVE_CAP
    dst = torch.full((cs.SERVE_CAP,), 0x7FFFFFFF, dtype=torch.int32,
                     device=dev)
    dst[:cs.SERVE_EDGES] = torch.sort(torch.randint(
        0, cs.SERVE_NODES, (cs.SERVE_EDGES,), generator=gen, device=dev,
        dtype=torch.int32)).values
    for d in (602, 1):
        msgs = torch.randn((cs.SERVE_CAP, d), generator=gen, device=dev)
        out[f"synthetic_d{d}"] = reading(dst, msgs, cs.SERVE_NODES)
        del msgs
    del dst
    part = {}
    n = cs.PARTITION_TIMED[0]
    vals = torch.randint(-2**31, 2**31 - 1, (n,), generator=gen, device=dev,
                         dtype=torch.int32)
    cond = torch.rand((n,), generator=gen, device=dev) < 0.4
    for block in (1024, 96, 1000, 4100):
        m = n // block * block
        v, c = vals[:m], cond[:m]
        got = tpp.prefix_partition(v, c, block)
        want = tpp._partition_plain(v, c, block)
        cs.check(all(torch.equal(a, w) for a, w in zip(got, want)),
                 f"{tree} prefix_partition block {block} == twin")
        part[f"block{block}"] = dict(
            n=m, ms=cs.cuda_ms(lambda v=v, c=c, block=block:
                               tpp.prefix_partition(v, c, block)))
    out["prefix_partition"] = part
    del vals, cond
    torch.cuda.empty_cache()
    return dict(tree=tree, fused=fused, **out)


def turn_decode(tree: str, seed: int) -> dict:
    """One tree's decode attention readings, in this process."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as tda
    from repro_torch.models.attention import (decode_attention_plain,
                                              decode_mask, dequantize_kv,
                                              quantize_kv)

    import repro_torch
    assert repro_torch.__file__.startswith(os.path.abspath(tree)), (
        repro_torch.__file__, tree)
    dev = torch.device("cuda", 0)
    _build.build(("decode_attention",))
    h, hkv, dh = 16, 8, 256
    out = dict(resources=cs.resource_usage("decode_attention",
                                           "decode_split_kernel"))
    for name, s, lens in DECODE_SHAPES:
        g = torch.Generator(device=dev).manual_seed(seed)
        b = len(lens)
        q = torch.randn((b, h, 1, dh), generator=g, device=dev).to(
            torch.bfloat16)
        k, ks = quantize_kv(torch.randn((b, hkv, s, dh), generator=g,
                                        device=dev))
        v, vs = quantize_kv(torch.randn((b, hkv, s, dh), generator=g,
                                        device=dev))
        cl = torch.tensor(lens, dtype=torch.int32, device=dev)
        kw = dict(logit_cap=50.0, k_scale=ks, v_scale=vs)

        def kernel():
            return tda.decode_attention(q, k, v, cl, **kw)
        got = kernel()
        n = 1 if s > 4096 else b
        sub = dict(logit_cap=50.0, k_scale=ks[:n], v_scale=vs[:n])
        want = decode_attention_plain(q[:n], k[:n], v[:n], cl[:n], **sub)
        tol = tda.twin_tolerance(q[:n], k[:n], v[:n], cl[:n], **sub)
        diff = (got[:n].double() - want.double()).abs()
        share = float(torch.where(diff == 0, 0.0, diff / tol).max())
        cs.check(share <= 1.0, f"{tree} {name}: the kernel within "
                 f"twin_tolerance of the twin ({share})")
        del want, tol, diff
        ms = cs.cuda_ms(kernel)
        kd, vd = (dequantize_kv(c, sc).repeat_interleave(h // hkv, 1)
                  for c, sc in ((k, ks), (v, vs)))
        mask = decode_mask(cl, s)[:, None, None, :]
        lib_ms = cs.cuda_ms(lambda: F.scaled_dot_product_attention(
            q, kd, vd, attn_mask=mask))
        del kd, vd, k, v, ks, vs
        live = int(torch.clamp(cl, max=s).sum())
        nbytes = live * hkv * (2 * dh + 2 * 4) + 2 * q.numel() * 2
        b_ms, b_by = cs.bound(nbytes, 4 * dh * (h // hkv) * live * hkv)
        out[name] = dict(cache=s, lens=list(lens), ms=ms,
                         share_of_bound=b_ms / ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=lib_ms,
                         share_of_tol=share,
                         bits=int(got.view(torch.int16).to(torch.int64)
                                  .sum()))
        del got
        torch.cuda.empty_cache()
    return dict(tree=tree, **out)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=DIR, a checkout's root (repeatable)")
    ap.add_argument("--order", help="tree names in turn order, by commas")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--what", choices=("slice", "kernels", "digit", "serve",
                                       "scan", "segsum", "decode", "plain"),
                    default="slice",
                    help="the SLICE_CFG request and rank calls; the chunk "
                    "sort, the filter, the merge kernels and the MERGE_CFG "
                    "convert; the global_radix digit pass, sort and "
                    "SLICE_CFG convert; both configurations' serving; "
                    "the pointer segment sum on the path's pointers; "
                    "the dst-sorted segment sum and the prefix partition; "
                    "the decode attention kernel; or the plain path "
                    "(the twins, plain converts, GNN training)")
    ap.add_argument("--turn", help=argparse.SUPPRESS)  # NAME=DIR, one turn
    args = ap.parse_args()

    if args.turn:
        name, tree = args.turn.split("=", 1)
        out = (turn_kernels(tree, args.seed) if args.what == "kernels" else
               turn_digit(tree, args.seed) if args.what == "digit" else
               turn_serve(tree, args.seed, args.requests)
               if args.what == "serve" else
               turn_scan(tree, args.seed) if args.what == "scan" else
               turn_segsum(tree, args.seed) if args.what == "segsum" else
               turn_decode(tree, args.seed) if args.what == "decode" else
               turn_plain(tree, args.seed) if args.what == "plain" else
               turn(tree, args.seed, args.requests, args.reps))
        print(json.dumps(dict(name=name, **out)), flush=True)
        return 0
    trees = dict(t.split("=", 1) for t in args.tree)
    order = args.order.split(",") if args.order else list(trees)
    if not trees or any(n not in trees for n in order):
        ap.error(f"--order {order} names a tree not given by --tree")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0].strip()
    print(smi, flush=True)
    results = []
    for name in order:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--turn",
             f"{name}={trees[name]}", "--seed", str(args.seed),
             "--requests", str(args.requests), "--reps", str(args.reps),
             "--what", args.what],
            capture_output=True, text=True)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            print(f"turn {name} failed ({proc.returncode})", flush=True)
            return 1
        results.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(results[-1]), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "slice_ab.json"), "w") as f:
        json.dump(dict(card=smi, what=args.what, order=order, trees=trees,
                       turns=results), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
