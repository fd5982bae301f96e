#!/usr/bin/env python3
"""Profile a short run of small kernels many times under ``torch.profiler``
and report whether any of their kernel records went missing, and how far
each trace's last kernel ends from its last host event (negative: before
it). Three tails follow the kernels in turn: none, 256 short spin kernels,
and a 50 ms spin before those 256 (``chip_smoke.py``'s ``profile_call``).

  python3 tools/trace_window_probe.py [--seconds 90]

Needs a CUDA card. Prints one JSON line: the profiled runs, the runs that
kept fewer than all their kernels (the first 20), and the five largest
and the smallest last-kernel-minus-last-host-event ends, in µs.
"""
import argparse
import json
import time

N_KERNELS = 64


def run(tail):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(1024, device="cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(256):
            torch.cuda._sleep(1000)
        torch.cuda._sleep(20_000_000)
        torch.cuda.synchronize()
        for _ in range(N_KERNELS):
            x.add_(1.0)
        torch.cuda.synchronize()
        if tail == "long":
            torch.cuda._sleep(100_000_000)
        if tail in ("short", "long"):
            for _ in range(256):
                torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    ev = prof.events()
    kept = sum(1 for e in ev if e.device_type == DeviceType.CUDA
               and "spin" not in e.name)
    cpu_end = max(e.time_range.end for e in ev
                  if e.device_type == DeviceType.CPU)
    gpu_end = max(e.time_range.end for e in ev
                  if e.device_type == DeviceType.CUDA)
    return dict(tail=tail, kept=kept, lead_us=gpu_end - cpu_end)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=90.0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    out = []
    t0 = time.time()
    while time.time() - t0 < args.seconds:
        for tail in ("none", "short", "long"):
            out.append(run(tail))
        time.sleep(0.2)
    lost = [r for r in out if r["kept"] != N_KERNELS]
    leads = sorted(r["lead_us"] for r in out)
    print(json.dumps(dict(runs=len(out), n_lost=len(lost), lost=lost[:20],
                          lead_us_largest=leads[-5:],
                          lead_us_smallest=leads[0])))


if __name__ == "__main__":
    main()
