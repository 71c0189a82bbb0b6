"""HTTP serving endpoint for trained diffusion models (counterpart of the
repository's ``serve.py``).

    python -m duodiff_tpu_torch.serve --config_path configs/uvit_celeba.yaml \\
        --checkpoint_path <ckpt.pth> --port 8861 [--method ddpm|ddim|dpm] [--slots 8]

    curl -s localhost:8861/healthz
    curl -s -X POST localhost:8861/sample -d '{"n": 2, "seed": 7}' \\
        | python -c 'import json,sys,base64; \\
            [open(f"s{i}.png","wb").write(base64.b64decode(im)) \\
             for i, im in enumerate(json.load(sys.stdin)["images"])]'

Two modes. The fixed bucket (``--bucket N``, the default N = 1) runs each
request's images in chunks of N, one whole trajectory a chunk, under a
lock. ``--slots N`` is mixed-timestep continuous batching
(:mod:`duodiff_tpu_torch.diffusion.continuous`): one step over N slots,
each at its own timestep, so concurrent requests share every forward; a
device-loop thread, the only thread that runs the model, admits queued
images into free slots between advances, and HTTP threads wait on futures.
A failure in that thread fails every waiter (HTTP 503); from then on new
requests are refused with 503 and ``/healthz`` answers 503 with status
``stopped`` and the error.

Randomness, the same in both modes: image j of a request with seed s draws
from a ``torch.Generator`` on the serving device seeded
:func:`image_seed` ``(s, j)`` (a bucket chunk from its first image's), so a
request's images from the bucket-1 server equal the continuous server's
(to the bit with the plain PyTorch path on the CPU). A class-conditional
model's labels, where the request names no class, come from a CPU
generator seeded ``s ^ 0x5EED``. The JAX server uses threefry keys, so its
images for a seed are not these.

``--method`` defaults to ``ddpm``, the full reverse process (the JAX server
defaults to DPM-Solver++ 20 steps, whose samples score far from DDPM's).
``--device`` defaults to ``cuda`` and ``--attn_impl`` to ``fused`` there
(``plain`` on the CPU); there is no fallback to the CPU. Refused:
``--int8_scales`` with ``--static_schedule`` (the truncated backbones run
int8 with dynamic MLP scales). A latent config's samples are decoded by its
frozen autoencoder before the PNG is written (``utils/image.py``'s writer).

Under ``python -m torch.distributed.run --nproc_per_node N`` every rank runs
``main`` on the process grid of ``parallel/mesh.py:sampling_grid`` (the
bucket, or the slots, as its batch): ``--model_parallel M`` shards every
block's heads and hidden columns over groups of M ranks (``fused`` only),
and the bucket or the slots split over the N / M data ranks where they
divide them, else every rank runs them whole. Rank 0 alone binds
``--port`` and answers HTTP; the others build the same service and follow.
One thread a rank issues the grid's collectives, in one order: the request
lock's holder (bucket) or the device-loop thread (slots). Rank 0 broadcasts
each unit of work over the host, a bucket chunk's image seed and labels or
a slot round's admissions and advance, and a stop when it closes. A chunk's
generator draws the whole chunk and each data rank keeps its rows
(``diffusion/sampling.py:RowDraws``); a slot lives on one data rank
(``diffusion/continuous.py``); rank 0 gathers the images on the host, so
they are the one-process server's (within 2 pixel levels under
``--model_parallel``, whose sums run in another order). Every collective
fails after ``parallel/mesh.py:SERVE_TIMEOUT``: a rank that dies or hangs
fails the request with 503, and the server then answers 503 with status
``stopped``. The static-exit family serves on rank 0's device alone, and
``--model_parallel`` with ``--static_schedule`` is refused.

On a CUDA device the steps replay as CUDA graphs (``diffusion/graphs.py``),
except under ``--model_parallel``, whose steps hold all-reduces over the
host: the bucket server keeps its samplers' graphs, keyed by batch size,
method and cache rule, for its life (captured by the first chunk, the
warm-up's by default, under the request lock), and the continuous server
captures each kind of step on its device-loop thread before it takes a
request. A failed capture stops the server from starting.
"""

from __future__ import annotations

import argparse
import base64
import collections
import concurrent.futures
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch


def get_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config_path", type=str, required=True)
    p.add_argument("--checkpoint_path", type=str, default=None)
    p.add_argument("--random_init", action="store_true")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8861)
    p.add_argument("--method", type=str, default="ddpm", choices=["dpm", "ddpm", "ddim"],
                   help="ddpm (default: the full reverse process), ddim or DPM-Solver++ 2M")
    p.add_argument("--steps", type=int, default=None,
                   help="model calls per image (default: 20 dpm / num_timesteps ddpm / 50 ddim)")
    p.add_argument("--num_timesteps", type=int, default=1000)
    p.add_argument("--bucket", type=int, default=1,
                   help="batch of the fixed-bucket sampler; requests are padded/chunked onto it")
    p.add_argument("--parametrization", type=str, default="predict_noise")
    p.add_argument("--guidance_scale", type=float, default=None,
                   help="classifier-free guidance weight (needs a class-conditional model "
                        "trained with --label_dropout; requests must pass class_id)")
    p.add_argument("--null_class", type=int, default=None,
                   help="null-label index for guidance (default num_classes-1)")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--attn_impl", type=str, default=None,
                   choices=["fused", "plain", "fused_int8", "pallas", "xla"],
                   help="the block (default: fused on CUDA, plain on the CPU)")
    p.add_argument("--gelu_approx", action="store_true")
    p.add_argument("--use_ema", action="store_true",
                   help="serve the EMA weights of an --ema_decay-trained checkpoint")
    p.add_argument("--int8_scales", type=str, default=None,
                   help="tools/calibrate_int8.py JSON: static MLP activation scales for "
                        "--attn_impl fused_int8")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="tensor-parallel degree over the ranks of torch.distributed.run: shard "
                        "the heads and the MLP hidden columns over groups of this many ranks; "
                        "the other ranks form the data axis the bucket or the slots split over")
    p.add_argument("--warmup", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--slots", type=int, default=0,
                   help="mixed-timestep continuous batching with this many slots (0 = "
                        "fixed-bucket serving)")
    p.add_argument("--steps_per_poll", type=int, default=5,
                   help="continuous mode: steps per host round of the device loop; finished "
                        "slots wait at most this many extra steps")
    p.add_argument("--cache_every", type=int, default=None,
                   help="training-free block caching: recompute the centered blocks only on "
                        "anchor steps (dpm/ddpm; in continuous mode admissions are "
                        "phase-aligned so the whole slot batch anchors together)")
    p.add_argument("--cache_outer", type=int, default=None,
                   help="blocks per side recomputed every step under caching (default "
                        "ceil(depth/2 / 3))")
    p.add_argument("--cache_schedule", type=str, default=None,
                   help="drift-derived anchor-table JSON (ddpm) in place of --cache_every. In "
                        "--slots mode the table must fold to a periodic wave pattern")
    p.add_argument("--cache_pattern", type=str, default=None,
                   help="periodic anchor pattern like '1,0,0,1,0' (1 = anchor; ddpm; "
                        "pattern[0] must be 1). The fixed bucket runs its absolute-t table")
    p.add_argument("--static_schedule", type=str, default=None,
                   help="serve the static-exit family (an EarlyExitUViT checkpoint; "
                        "'hi-lo:layer,...', eesample's format): ddpm, fixed bucket; composes "
                        "with the cache flags and --attn_impl fused_int8")
    return p.parse_args(argv)


def image_seed(seed: int, index: int) -> int:
    """The seed of the generator of image ``index`` of a request with
    ``seed``: ``(seed * 1_000_003 + index) mod 2**63``."""
    return (int(seed) * 1_000_003 + int(index)) % 2**63


def label_generator(seed: int) -> torch.Generator:
    """The CPU generator of a request's random labels: seeded ``seed ^ 0x5EED``."""
    return torch.Generator().manual_seed((int(seed) ^ 0x5EED) % 2**63)


class _ServiceBase:
    """Model loading, guidance, method and steps, the cache rules and request
    validation, shared by the two serving modes."""

    def __init__(self, args):
        from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
        from duodiff_tpu_torch.parallel.mesh import SERVE_TIMEOUT, sampling_grid
        from duodiff_tpu_torch.sample import check_parallel_flags, latent_decoder
        from duodiff_tpu_torch.utils.model_loading import load_model

        if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
            raise SystemExit(f"--device {args.device}: no CUDA device is available")
        if not args.random_init and args.checkpoint_path is None:
            raise SystemExit("--checkpoint_path is required (or pass --random_init)")
        self.static_buckets = None
        if args.static_schedule:
            if args.method != "ddpm":
                raise SystemExit("--static_schedule serves the ddpm static-exit family "
                                 f"(got --method {args.method})")
            if args.slots:
                raise SystemExit(
                    "--static_schedule is fixed-bucket only: each bucket is a different "
                    "truncated backbone, and mixed-timestep slots would need per-slot depths")
            if args.parametrization != "predict_noise":
                raise SystemExit("static-exit serving is predict_noise only (the output heads "
                                 "are trained under it)")
            if args.int8_scales is not None:
                raise SystemExit("--int8_scales with --static_schedule: the truncated backbones "
                                 "run int8 with dynamic MLP scales (the JAX server drops the "
                                 "file there silently)")
            from duodiff_tpu_torch.diffusion.static_exit import parse_exit_schedule

            self.static_buckets = parse_exit_schedule(args.static_schedule)
        mp = args.model_parallel or 1
        if mp > 1 and self.static_buckets is not None:
            raise SystemExit("--model_parallel does not combine with --static_schedule (each "
                             "truncated bucket would need its own sharded backbone): serve the "
                             "static-exit family without --model_parallel")
        attn_impl = args.attn_impl or ("fused" if args.device.startswith("cuda") or mp > 1
                                       else "plain")
        check_parallel_flags(args, attn_impl)

        # the static-exit family serves on rank 0's device alone
        self.grid = sampling_grid(mp, args.slots or args.bucket, args.device,
                                  split=self.static_buckets is None, timeout=SERVE_TIMEOUT)
        self._failure = None  # the error that stopped the service, once one did
        device = self.grid.device
        if device.type == "cuda" and device.index is None:  # the device-loop thread sets it
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        model, cfg = load_model(
            args.config_path, None if args.random_init else args.checkpoint_path,
            device=device, attn_impl=attn_impl, gelu_approx=args.gelu_approx,
            int8_scales=args.int8_scales, use_ema=args.use_ema,
            early_exit=self.static_buckets is not None, grid=self.grid,
        )
        model.eval().pack_for_kernels()
        self.model, self.cfg, self.args = model, cfg, args
        self.attn_impl = attn_impl
        self.requests_served = 0
        self.decode_fn = latent_decoder(args.config_path, device)
        self.schedule = NoiseSchedule.create(steps=args.num_timesteps, device=device)
        from duodiff_tpu_torch.diffusion.graphs import StepGraphs
        from duodiff_tpu_torch.sample import graph_route

        graphed, route = graph_route(device, self.grid.model)
        self.graphs = StepGraphs(device, graphed)  # for the server's life
        if self.grid.is_main:
            print(route, flush=True)

        apply_fn = model
        self.guidance_null = None
        if args.guidance_scale is not None:
            null_class = args.null_class if args.null_class is not None else cfg.num_classes - 1
            if null_class < 1:
                raise SystemExit("--guidance_scale needs a class-conditional model with a "
                                 f"reserved null slot (num_classes={cfg.num_classes})")
            from duodiff_tpu_torch.diffusion.sampling import make_guided_apply

            self.guidance_null = null_class
            # static-exit serving guides each truncated bucket instead
            if self.static_buckets is None:
                apply_fn = make_guided_apply(apply_fn, args.guidance_scale, null_class)
        self.apply_fn = apply_fn

        method = args.method
        if method == "dpm" and args.parametrization == "predict_previous":
            raise SystemExit("dpm supports predict_noise/predict_original")
        if method == "ddim" and args.parametrization != "predict_noise":
            raise SystemExit("ddim serving supports predict_noise only")
        if method == "dpm":
            steps = args.steps or 20
        elif method == "ddim":
            steps = args.steps or 50
        else:
            if args.steps is not None and args.steps != args.num_timesteps:
                raise SystemExit(
                    f"ddpm runs the full reverse process (--num_timesteps={args.num_timesteps}); "
                    "--steps only applies to dpm/ddim — for fewer ddpm steps shorten "
                    "--num_timesteps (and retrain: the beta range is schedule-length dependent)")
            steps = args.num_timesteps
        self.steps, self.method = steps, method
        self.cache = None
        self.cache_rule = self._cache_rule(args, method)
        if self.cache_rule is not None:
            if args.cache_every is not None and args.cache_every < 1:
                raise SystemExit("--cache_every must be >= 1")
            if method not in ("dpm", "ddpm"):
                raise SystemExit("--cache_every serving supports dpm/ddpm methods")
            if args.guidance_scale is not None:
                raise SystemExit("--cache_every does not compose with --guidance_scale")
            k_half = cfg.depth // 2
            n_outer = args.cache_outer if args.cache_outer is not None else max(1, -(-k_half // 3))
            if not 1 <= n_outer <= k_half:
                raise SystemExit(f"--cache_outer must be in [1, {k_half}] for depth "
                                 f"{cfg.depth}, got {n_outer}")
            if self.static_buckets is None:
                # static-exit serving caches inside each truncated backbone
                # (make_static_exit_sampler) instead
                tokens = cfg.extras + cfg.num_patches
                self.cache = (
                    lambda x, t, y: model.forward_anchor(x, t, y, n_outer=n_outer),
                    lambda x, t, y, d: model.forward_cached(x, t, y, n_outer=n_outer, delta=d),
                    self.cache_rule,
                    lambda x: torch.zeros((x.shape[0], tokens, cfg.embed_dim),
                                          dtype=model.dtype, device=x.device),
                )
        elif args.cache_outer is not None:
            raise SystemExit("--cache_outer requires --cache_every")

    def _cache_rule(self, args, method):
        """The anchor rule of the cache flags: an int period, a boolean
        table indexed by t (fixed bucket) or a wave-index pattern (slots),
        or None without caching."""
        from duodiff_tpu_torch.diffusion.continuous import (
            fold_table_to_pattern,
            periodic_pattern_table,
        )

        given = [a for a in (args.cache_every, args.cache_schedule, args.cache_pattern)
                 if a is not None]
        if len(given) > 1:
            raise SystemExit("pass ONE of --cache_every / --cache_schedule / --cache_pattern")
        if args.cache_pattern is not None:
            if method != "ddpm":
                raise SystemExit("--cache_pattern is t-indexed ddpm caching (dpm anchors on its "
                                 "own grid indices: use --cache_every)")
            try:
                pattern = np.asarray([int(v) for v in args.cache_pattern.split(",")], bool)
            except ValueError:
                raise SystemExit(f"--cache_pattern {args.cache_pattern!r}: expected a comma "
                                 "list of 0/1") from None
            if pattern.size < 1 or not pattern[0]:
                raise SystemExit("--cache_pattern[0] must be 1 (a fresh trajectory's first "
                                 "step needs a real delta)")
            # slots mode takes the wave-index pattern; the fixed bucket runs
            # the equivalent absolute-t table
            return pattern if args.slots else periodic_pattern_table(pattern, self.schedule.steps)
        if args.cache_schedule is not None:
            from duodiff_tpu_torch.diffusion.cache_schedule import load_cache_schedule

            if method != "ddpm":
                raise SystemExit("--cache_schedule is a t-indexed ddpm anchor table (dpm "
                                 "anchors on grid indices: use --cache_every)")
            table = load_cache_schedule(args.cache_schedule, num_timesteps=self.schedule.steps)
            if not args.slots:
                return table
            pattern = fold_table_to_pattern(table)
            if pattern is None:
                raise SystemExit(
                    "--cache_schedule table is aperiodic (or its t=T-1 entry is not an "
                    "anchor): mixed-timestep slots need a slot-uniform anchor decision, so only "
                    "wave-periodic schedules can ride continuous batching (an arbitrary t-keyed "
                    "table would make slots at different t disagree). Serve this table in "
                    "fixed-bucket mode (--slots 0), or pass a periodic --cache_pattern")
            return pattern
        return args.cache_every

    def _resolve_labels(self, seed, class_id, count):
        """Validate class_id and return the (count,) labels on the CPU, or
        None for an unconditional model. The same in both modes: random
        labels come from :func:`label_generator` of the request's seed."""
        if self.guidance_null is not None and class_id is None:
            raise ValueError("guided server: requests must pass class_id")
        if class_id is not None and self.cfg.num_classes <= 0:
            raise ValueError("model is unconditional; class_id invalid")
        if self.cfg.num_classes <= 0:
            return None
        hi = self.guidance_null if self.guidance_null is not None else self.cfg.num_classes
        if class_id is not None:
            if not 0 <= int(class_id) < hi:
                raise ValueError(f"class_id must be in [0, {hi})")
            return torch.full((count,), int(class_id), dtype=torch.long)
        # every real class; the top slot is left out only when --null_class
        # reserves it (a guided server requires class_id and never gets here)
        top = self.args.null_class if self.args.null_class is not None else hi
        return torch.randint(0, max(top, 1), (count,), generator=label_generator(seed))

    def _in_device_context(self):
        """Make the serving device the calling thread's current CUDA device."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)

    def warmup(self):
        tic = time.time()
        self.sample(n=1, seed=0, class_id=0 if self.guidance_null is not None else None)
        return time.time() - tic

    @property
    def sharded(self) -> bool:
        """Whether the batch or the model is split over the grid's ranks."""
        return self.grid.distributed and not self.grid.replicated

    @property
    def healthy(self) -> bool:
        return self._failure is None

    def follow(self):
        """A follower rank's loop: do each unit of work rank 0 broadcasts, in
        order, until its stop (None)."""
        try:
            with torch.inference_mode():
                self._in_device_context()
                self._follow()
        except BaseException as e:
            self._failure = e
            raise

    def info(self):
        cuda = self.device.type == "cuda"
        grid = self.grid
        stopped = {}
        if self._failure is not None:
            stopped = {"status": "stopped", "error": repr(self._failure)}
        return {
            "status": "ok",
            **stopped,
            "card": torch.cuda.get_device_name(self.device) if cuda else "cpu",
            "devices": torch.cuda.device_count() if cuda else 1,
            "mesh": {"data": grid.data, "model": grid.model} if self.sharded else None,
            "model_parallel": grid.model,
            "attn_impl": self.attn_impl,
            "method": self.method,
            "steps": self.steps,
            "img_size": self.cfg.img_size,
            "num_classes": self.cfg.num_classes,
            "latent": self.decode_fn is not None,
            "guidance_scale": self.args.guidance_scale,
            "requests_served": self.requests_served,
        }

    def close(self):
        pass


class SamplerService(_ServiceBase):
    """Fixed-bucket serving: one bucket-sized sampler and a lock. Requests
    are padded/chunked onto the bucket and run whole trajectories back to
    back, one generator a chunk; on a data-parallel grid each rank runs its
    rows of the chunk."""

    def __init__(self, args):
        super().__init__(args)
        from duodiff_tpu_torch.diffusion.sampling import (
            DDPMSampler,
            ddim_sample,
            dpm_solver_sample,
            make_block_cached_apply,
        )

        cfg, schedule, apply_fn, cache = self.cfg, self.schedule, self.apply_fn, self.cache
        self.bucket = args.bucket
        self.rows = self.grid.rows(args.bucket)  # this rank's rows of a chunk
        self.shape = (self.rows[1] - self.rows[0], cfg.img_size, cfg.img_size, cfg.in_chans)
        self.lock = threading.Lock()

        if self.static_buckets is not None:
            from duodiff_tpu_torch.diffusion.static_exit import make_static_exit_sampler

            guidance = ((args.guidance_scale, self.guidance_null)
                        if args.guidance_scale is not None else None)
            static = make_static_exit_sampler(
                self.model, schedule=schedule, buckets=self.static_buckets, guidance=guidance,
                cache_every=self.cache_rule, cache_outer=args.cache_outer, graphs=self.graphs)
            self._run = lambda g, y: static(g, self.shape, y)
        elif self.method == "dpm":
            self._run = lambda g, y: dpm_solver_sample(
                apply_fn, g, schedule=schedule, shape=self.shape, dpm_steps=self.steps,
                parametrization=args.parametrization, y=y, cache=cache, graphs=self.graphs)
        elif self.method == "ddim":
            self._run = lambda g, y: ddim_sample(
                apply_fn, g, schedule=schedule, shape=self.shape, ddim_steps=self.steps,
                eta=0.0, y=y, graphs=self.graphs)[0]
        else:
            t_first = schedule.steps - 1
            if cache is not None:
                sampler = DDPMSampler(make_block_cached_apply(cache[0], cache[1], cache[2], t_first),
                                      schedule, parametrization=args.parametrization,
                                      init_state_fn=cache[3], graphs=self.graphs)
            else:
                sampler = DDPMSampler(apply_fn, schedule, parametrization=args.parametrization,
                                      graphs=self.graphs)

            def run_ddpm(g, y):
                x = sampler.init(g, self.shape)
                if cache is None:
                    return sampler.run(x, g, t_first, 0, y)
                return sampler.run(x, g, t_first, 0, y, state=cache[3](x))[0]

            self._run = run_ddpm

    def _chunk(self, gen_seed: int, y):
        """One chunk on this rank: its rows of the chunk's draws from the
        generator seeded ``gen_seed``, the labels ``y`` (bucket,) or None;
        the whole chunk's images (bucket, H, W, C) in [0, 1], gathered from
        the data ranks on the host."""
        from duodiff_tpu_torch.diffusion.sampling import RowDraws

        lo, hi, _ = self.rows
        g = torch.Generator(device=self.device).manual_seed(gen_seed)
        if self.sharded:
            g = RowDraws(g, self.rows)
        if y is not None:
            y = y[lo:hi].to(self.device)
        x = self._run(g, y)
        if self.decode_fn is not None:
            x = self.decode_fn(x)
        return self.grid.gather_rows(((x + 1.0) / 2.0).float().cpu()).numpy()

    def _lead(self, gen_seed: int, y):
        """Rank 0's chunk: on a grid, broadcast it to the followers first;
        a failure there stops the service (the ranks are out of step)."""
        if not self.grid.distributed or self.static_buckets is not None:
            return self._chunk(gen_seed, y)
        if self._failure is None:
            try:
                self.grid.broadcast_obj((gen_seed, y))
                return self._chunk(gen_seed, y)
            except Exception as e:  # noqa: BLE001 — a collective or a rank's work failed
                self._failure = e
        # the handler answers 503: the server's state, not the request, is at fault
        raise RuntimeError(f"server is stopped: a rank of the serving grid failed: "
                           f"{self._failure!r}")

    def _follow(self):
        while (unit := self.grid.broadcast_obj()) is not None:
            self._chunk(*unit)

    def sample(self, n=1, seed=None, class_id=None):
        if seed is None:
            seed = int(time.time_ns()) % (2**31)
        y = self._resolve_labels(seed, class_id, self.bucket)
        imgs = []
        with self.lock, torch.inference_mode():
            self._in_device_context()
            done = 0
            while done < n:
                batch = self._lead(image_seed(seed, done), y)
                take = min(self.bucket, n - done)
                imgs.extend(batch[:take])
                done += take
            self.requests_served += 1
        return imgs

    def info(self):
        return {**super().info(), "mode": "bucket", "bucket": self.bucket}

    def close(self):
        """Rank 0 of a grid: the followers' stop."""
        if not (self.grid.is_main and self.grid.distributed):
            return
        with self.lock:
            if self._failure is None:
                try:
                    self.grid.broadcast_obj(None)
                except RuntimeError as e:  # a follower already gone
                    self._failure = e


class ContinuousSamplerService(_ServiceBase):
    """Mixed-timestep continuous batching: a device-loop thread advances
    every image in flight one shared step at a time; HTTP threads enqueue
    images and wait on futures. A request's images equal the bucket-1
    server's for the same seed where the model's rows do not depend on the
    batch. On a grid rank 0's device loop broadcasts each round, which the
    followers' loops (:meth:`follow`) repeat on their slots."""

    def __init__(self, args):
        super().__init__(args)
        from duodiff_tpu_torch.diffusion.continuous import ContinuousDiffusionBatcher

        cfg = self.cfg
        self.slots = args.slots
        with torch.inference_mode():
            self.batcher = ContinuousDiffusionBatcher(
                self.apply_fn, self.schedule,
                img_shape=(cfg.img_size, cfg.img_size, cfg.in_chans),
                slots=args.slots, method=self.method, parametrization=args.parametrization,
                ddim_steps=self.steps, dpm_steps=self.steps,
                steps_per_poll=args.steps_per_poll, conditional=cfg.num_classes > 0,
                cache=self.cache, mesh=self.grid if self.sharded else None,
                graphs=self.graphs.graphed,
            )
        self._cv = threading.Condition()
        self._queue = collections.deque()  # (generator seed, label or None, future)
        self._slot_jobs = {}  # slot -> future (device-loop thread only)
        self._stopped = False
        self._thread = None
        self._ready = threading.Event()  # the device loop's graphs are made (or it failed)
        if self.grid.is_main:
            self._thread = threading.Thread(target=self._device_loop, daemon=True)
            self._thread.start()
            self._ready.wait()
            if self._failure is not None:
                raise RuntimeError(f"the device loop failed before serving: "
                                   f"{self._failure!r}") from self._failure

    def _round(self, wave: dict, advance: bool, deferred):
        """One round of the device loop, the same on every rank: admit
        ``wave`` ({slot: (generator seed, label or None)}), advance if asked,
        deliver the last round's finished images (rank 0), start fetching
        this round's. Returns this round's (futures, materialize) or None."""
        batcher = self.batcher
        batcher.admit_many({
            slot: (torch.Generator(device=self.device).manual_seed(gen_seed), y)
            for slot, (gen_seed, y) in wave.items()})
        if advance:
            batcher.advance()
        if deferred is not None:
            for fut, img in zip(deferred[0], deferred[1]()):
                if fut is not None:
                    fut.set_result(img)
        done = batcher.finished()
        if not done:
            return None
        futs = [self._slot_jobs.pop(slot, None) for slot in done]
        return futs, batcher.begin_finish(done, self.decode_fn)

    def _tell(self, unit) -> None:
        """Rank 0: broadcast a round, or the stop (None), to the followers."""
        if self.grid.distributed:
            self.grid.broadcast_obj(unit)

    def _follow(self):
        self.batcher.capture_graphs()
        deferred = None
        while (unit := self.grid.broadcast_obj()) is not None:
            deferred = self._round(*unit, deferred)
        if deferred is not None:
            deferred[1]()

    def _device_loop(self):
        """The only thread that runs the model. One round: admit free slots
        from the queue, advance steps_per_poll steps, deliver finished
        slots. Progress is mirrored on the host, so no round waits for the
        device to learn who finished; the one blocking transfer, the
        finished images, is deferred a round: ``begin_finish`` gathers them,
        starts the copy and frees the slots, the next round admits and
        queues its advance, and only then does ``materialize()`` wait (on a
        data-parallel grid ``begin_finish`` waits for the gather itself)."""
        batcher = self.batcher
        deferred = None  # (futures, materialize) of the last round
        try:
            self._in_device_context()
            with torch.inference_mode():
                batcher.capture_graphs()
                self._ready.set()
                while True:
                    with self._cv:
                        while (not self._stopped and not self._queue and not self._slot_jobs
                               and deferred is None):
                            self._cv.wait()
                        if self._stopped:
                            if deferred is not None:
                                for fut, img in zip(deferred[0], deferred[1]()):
                                    fut.set_result(img)
                                deferred = None
                            self._tell(None)
                            # fail (never silently abandon) queued requests and
                            # slots mid-trajectory: the HTTP handler maps the
                            # RuntimeError to 503
                            err = RuntimeError("server is shutting down")
                            for _, _, fut in self._queue:
                                fut.set_exception(err)
                            self._queue.clear()
                            for fut in self._slot_jobs.values():
                                fut.set_exception(err)
                            self._slot_jobs.clear()
                            return
                        wave = {}
                        # cached batcher: admissions only on phase-aligned waves
                        if batcher.can_admit_cached():
                            for slot in batcher.free_slots():
                                if not self._queue:
                                    break
                                gen_seed, y, fut = self._queue.popleft()
                                wave[slot] = (gen_seed, y)
                                self._slot_jobs[slot] = fut
                        # held requests (no free slot, or a phase-blocked
                        # admission) need the advance below to make progress
                        advance = bool(self._slot_jobs or self._queue)
                    self._tell((wave, advance))
                    deferred = self._round(wave, advance, deferred)
        except BaseException as e:  # noqa: BLE001 — the sole device thread:
            # an escaped error must fail every waiter, or they block in
            # fut.result() for an hour
            with self._cv:
                self._stopped = True
                self._failure = e
                waiters = [f for _, _, f in self._queue]
                waiters += list(self._slot_jobs.values())
                if deferred is not None:
                    waiters += list(deferred[0])
                self._queue.clear()
                self._slot_jobs.clear()
                for fut in waiters:
                    if not fut.done():
                        fut.set_exception(e)
            self._ready.set()
            raise

    def sample(self, n=1, seed=None, class_id=None):
        if seed is None:
            seed = int(time.time_ns()) % (2**31)
        y_val = self._resolve_labels(seed, class_id, 1)
        y_scalar = None if y_val is None else int(y_val[0])
        futures = []
        with self._cv:
            if self._stopped:
                # the server's state, not the request, is at fault: the
                # handler answers 503
                if self._failure is not None:
                    raise RuntimeError(f"server is stopped: the device loop failed: "
                                       f"{self._failure!r}")
                raise RuntimeError("server is shutting down")
            for j in range(n):
                fut = concurrent.futures.Future()
                self._queue.append((image_seed(seed, j), y_scalar, fut))
                futures.append(fut)
            self._cv.notify()
        imgs = [(fut.result(timeout=3600) + 1.0) / 2.0 for fut in futures]
        with self._cv:  # many HTTP threads run sample() concurrently
            self.requests_served += 1
        return imgs

    def info(self):
        stopped = {}
        if self._stopped:
            stopped = {"status": "stopped",
                       "error": None if self._failure is None else repr(self._failure)}
        return {
            **super().info(),
            **stopped,
            "mode": "continuous",
            "slots": self.slots,
            "steps_per_poll": self.args.steps_per_poll,
            "in_flight": len(self._slot_jobs) + len(self._queue),
        }

    def close(self):
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=60)


def png_b64(img) -> str:
    """An image in [0, 1] (H, W, C) as a base64 PNG: times 255, clipped,
    truncated to uint8, as the JAX server writes it."""
    from duodiff_tpu_torch.utils.image import encode_png

    arr = np.clip(np.nan_to_num(np.asarray(img, np.float32)) * 255.0, 0, 255).astype(np.uint8)
    return base64.b64encode(encode_png(arr)).decode("ascii")


def make_handler(service):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # quiet by default
            pass

        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                info = service.info()
                self._json(200 if info["status"] == "ok" else 503, info)
            else:
                self._json(200, {"usage": "POST /sample {n, seed, class_id} ; GET /healthz"})

        def do_POST(self):
            if self.path != "/sample":
                self._json(404, {"error": "unknown endpoint"})
                return
            try:
                length = int(self.headers.get("Content-Length") or 0)
                req = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(req, dict):
                    raise ValueError("request body must be a JSON object")
                n = int(req.get("n", 1))
                if not 1 <= n <= 64:
                    raise ValueError("n must be in [1, 64]")
                seed = req.get("seed")
                class_id = req.get("class_id")
                tic = time.time()
                imgs = service.sample(
                    n=n,
                    seed=None if seed is None else int(seed),
                    class_id=None if class_id is None else int(class_id),
                )
                elapsed_ms = (time.time() - tic) * 1e3
                self._json(200, {
                    "images": [png_b64(im) for im in imgs],
                    "elapsed_ms": round(elapsed_ms, 2),
                    "method": service.method,
                    "steps": service.steps,
                })
            except (ValueError, KeyError, TypeError, json.JSONDecodeError) as e:
                self._json(400, {"error": str(e)})
            except RuntimeError as e:
                # a device-loop failure or shutdown through the request's
                # future: tell the client instead of dropping the connection
                self._json(503, {"error": str(e)})

    return Handler


def make_service(args):
    """The serving mode ``args`` ask for: continuous with ``--slots``, else
    the fixed bucket."""
    return ContinuousSamplerService(args) if args.slots > 0 else SamplerService(args)


def main(argv=None, *, ready_event=None, server_box=None):
    """Serve until interrupted (or ``server_box``'s server is shut down);
    a follower rank of a grid follows rank 0 until its stop."""
    from duodiff_tpu_torch.parallel.mesh import close

    args = get_args(argv)
    service = make_service(args)
    try:
        if service.grid.is_main:
            _serve(args, service, ready_event, server_box)
        else:
            service.follow()
    finally:
        service.close()
        close(service.grid, barrier=service.healthy)


def _serve(args, service, ready_event, server_box):
    """Rank 0: the warmup, then HTTP on ``--port``."""
    mode = f"{args.slots}-slot continuous" if args.slots > 0 else f"bucket-{args.bucket}"
    if args.warmup:
        dt = service.warmup()
        print(f"warmup: first {service.method}-{service.steps} {mode} sample in {dt:.1f}s")
    httpd = ThreadingHTTPServer((args.host, args.port), make_handler(service))
    if server_box is not None:
        server_box.append((httpd, service))
    print(f"serving on http://{args.host}:{httpd.server_address[1]} ({service.info()})",
          flush=True)
    if ready_event is not None:
        ready_event.set()
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()


if __name__ == "__main__":
    main()
