"""Serving A/B under concurrent load: fixed bucket against continuous
batching (counterpart of the repository's ``tools/bench_serving.py``).

Drives the service classes of :mod:`duodiff_tpu_torch.serve` directly (no
HTTP or PNG layer, which would serialize on the host and hide the device's
difference) with ``--clients`` threads, each sending
``--requests_per_client`` single-image requests back to back, and reports
throughput and latency percentiles per mode. The bucket server runs one
request's whole trajectory at a time while the others queue; the slot
server advances every request in flight with each step.

    python -m duodiff_tpu_torch.tools.bench_serving \\
        --config_path configs/uvit_celeba.yaml --random_init \\
        --clients 8 --requests_per_client 4 --slots 8

Prints one JSON line per mode, then the ratio of the two:
    {"mode": "bucket", "throughput_img_s": ..., "p50_ms": ..., ...}
    {"continuous_vs_bucket_throughput": ..., "p50_latency_ratio": ...}
``--method`` defaults to the server's, ``ddpm``.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time


def get_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config_path", type=str, required=True)
    p.add_argument("--checkpoint_path", type=str, default=None)
    p.add_argument("--random_init", action="store_true")
    p.add_argument("--method", type=str, default="ddpm")
    p.add_argument("--steps", type=int, default=None,
                   help="solver steps; default 20 for ddim/dpm, num_timesteps for ddpm (the "
                        "full reverse process, which the server requires)")
    p.add_argument("--num_timesteps", type=int, default=1000)
    p.add_argument("--clients", type=int, default=8)
    p.add_argument("--requests_per_client", type=int, default=4)
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--steps_per_poll", type=int, default=5)
    p.add_argument("--bucket", type=int, default=1)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--attn_impl", type=str, default=None)
    p.add_argument("--gelu_approx", action="store_true")
    p.add_argument("--int8_scales", type=str, default=None)
    p.add_argument("--cache_every", type=int, default=None,
                   help="block caching in both serving modes (continuous admissions become "
                        "phase-aligned)")
    p.add_argument("--cache_outer", type=int, default=None)
    p.add_argument("--cache_schedule", type=str, default=None,
                   help="derived anchor table (bucket mode; slots mode folds periodic tables)")
    p.add_argument("--cache_pattern", type=str, default=None,
                   help="wave-index anchor pattern, e.g. '1,0,1,0'")
    p.add_argument("--static_schedule", type=str, default=None,
                   help="serve the static-exit buckets (EarlyExitUViT; bucket mode only)")
    p.add_argument("--modes", type=str, default="bucket,continuous")
    return p.parse_args(argv)


def run_load(service, clients: int, per_client: int):
    """``clients`` threads x ``per_client`` sequential single-image requests;
    returns (wall seconds, sorted latencies in ms)."""
    latencies = []
    lock = threading.Lock()

    def client(cid):
        for r in range(per_client):
            tic = time.time()
            service.sample(n=1, seed=cid * 1000 + r)
            dt = (time.time() - tic) * 1e3
            with lock:
                latencies.append(dt)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
    tic = time.time()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return time.time() - tic, sorted(latencies)


def main(argv=None) -> dict:
    """Run the A/B; returns {mode: its JSON line} (and the ratio line under
    "ratio" when both modes ran)."""
    from duodiff_tpu_torch import serve

    args = get_args(argv)
    if args.steps is None:
        args.steps = args.num_timesteps if args.method == "ddpm" else 20
    base_flags = [
        "--config_path", args.config_path, "--method", args.method,
        "--steps", str(args.steps), "--num_timesteps", str(args.num_timesteps),
        "--device", args.device,
    ]
    for flag in ("checkpoint_path", "attn_impl", "int8_scales", "cache_every", "cache_outer",
                 "cache_schedule", "cache_pattern", "static_schedule"):
        value = getattr(args, flag)
        if value is not None:
            base_flags += [f"--{flag}", str(value)]
    if args.random_init:
        base_flags += ["--random_init"]
    if args.gelu_approx:
        base_flags += ["--gelu_approx"]

    modes = args.modes.split(",")
    if args.static_schedule is not None and "continuous" in modes:
        # the slot server would refuse it after the bucket pass ran
        print("--static_schedule is fixed-bucket only; dropping the 'continuous' mode from "
              "this run", file=sys.stderr)
        modes = [m for m in modes if m != "continuous"]

    n_total = args.clients * args.requests_per_client
    results = {}
    for mode in modes:
        if mode == "bucket":
            svc = serve.SamplerService(serve.get_args(base_flags + ["--bucket", str(args.bucket)]))
        elif mode == "continuous":
            svc = serve.ContinuousSamplerService(serve.get_args(
                base_flags + ["--slots", str(args.slots),
                              "--steps_per_poll", str(args.steps_per_poll)]))
        else:
            raise SystemExit(f"unknown mode {mode}")
        try:
            tic = time.time()
            svc.warmup()
            print(f"[{mode}] warmup {time.time() - tic:.1f}s", file=sys.stderr)
            # the measured pass after a touch pass (kernels built, caches warm)
            run_load(svc, args.clients, 1)
            wall, lat = run_load(svc, args.clients, args.requests_per_client)
        finally:
            svc.close()
        out = {
            "mode": mode,
            "clients": args.clients,
            "requests": n_total,
            "throughput_img_s": round(n_total / wall, 3),
            "wall_s": round(wall, 3),
            "p50_ms": round(lat[len(lat) // 2], 1),
            "p90_ms": round(lat[int(len(lat) * 0.9)], 1),
            "max_ms": round(lat[-1], 1),
            "method": args.method,
            "steps": args.steps,
            "cache_every": args.cache_every,
        }
        results[mode] = out
        print(json.dumps(out), flush=True)
    if {"bucket", "continuous"} <= results.keys():
        speedup = results["continuous"]["throughput_img_s"] / results["bucket"]["throughput_img_s"]
        results["ratio"] = {
            "continuous_vs_bucket_throughput": round(speedup, 2),
            "p50_latency_ratio": round(results["continuous"]["p50_ms"]
                                       / results["bucket"]["p50_ms"], 2),
        }
        print(json.dumps(results["ratio"]), flush=True)
    return results


if __name__ == "__main__":
    main()
