"""``python -m duodiff_tpu_torch.serve`` and ``tools/bench_serving`` on the
CPU, mirroring ``tests/test_serve.py`` and the serving cases of
``tests/test_continuous.py``: the HTTP endpoints, the PNG round trip,
determinism per seed, the refusals, conditional and guided models,
static-exit serving against ``make_static_exit_sampler``, and the
continuous server equal to the bucket-1 server to the bit (with caching, a
pattern and a periodic table), a device-loop failure answered with 503.

The port's own differences from the JAX server are held here too: the
``ddpm`` default, one ``torch.Generator`` an image seeded ``image_seed(seed,
j)`` in place of threefry keys, the labels' CPU generator ``seed ^ 0x5EED``,
and the refusals of ``--model_parallel`` with ``--static_schedule`` and of
int8 scales with ``--static_schedule``. Serving over the process grid is
held by tests/test_torch_serve_grid.py."""

import base64
import json
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from duodiff_tpu_torch import serve
from duodiff_tpu_torch.diffusion.cache_schedule import save_cache_schedule, uniform_table
from duodiff_tpu_torch.diffusion.continuous import periodic_pattern_table
from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
from duodiff_tpu_torch.utils.image import decode_png

torch.set_num_threads(1)

TINY_YAML = """model_params:
  img_size: 16
  patch_size: 2
  in_chans: 3
  embed_dim: 32
  depth: 3
  num_heads: 4
  mlp_ratio: 4
  qkv_bias: False
  mlp_time_embed: False
  num_classes: -1
  normalize_timesteps: True
"""

TINY_EE_YAML = TINY_YAML + """  classifier_type: "mlp_probe_per_layer"
"""


@pytest.fixture(scope="module")
def cfg(tmp_path_factory):
    path = tmp_path_factory.mktemp("serve") / "tiny.yaml"
    path.write_text(TINY_YAML)
    return path


@pytest.fixture(scope="module")
def cond_cfg(tmp_path_factory):
    path = tmp_path_factory.mktemp("serve_cond") / "cond.yaml"
    path.write_text(TINY_YAML.replace("num_classes: -1", "num_classes: 10"))
    return path


def base_flags(cfg, *extra):
    return ["--config_path", str(cfg), "--random_init", "--device", "cpu", "--port", "0",
            "--num_timesteps", "32", *extra]


def start_server(argv):
    ready, box = threading.Event(), []
    th = threading.Thread(target=serve.main, args=(argv,),
                          kwargs={"ready_event": ready, "server_box": box}, daemon=True)
    th.start()
    assert ready.wait(timeout=300), "server did not come up"
    httpd, service = box[0]
    return httpd, service, f"http://127.0.0.1:{httpd.server_address[1]}"


def _get(url):
    with urllib.request.urlopen(url, timeout=120) as r:
        return json.loads(r.read())


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def served(cfg, extra, requests):
    """Start a server with ``extra`` flags, POST each of ``requests``, stop
    it; returns the responses' image lists."""
    httpd, _, base = start_server(base_flags(cfg, *extra))
    try:
        out = []
        for payload in requests:
            code, resp = _post(base + "/sample", payload)
            assert code == 200, resp
            out.append(resp["images"])
        return out
    finally:
        httpd.shutdown()


@pytest.fixture(scope="module")
def server(cfg):
    httpd, service, base = start_server(base_flags(cfg, "--method", "dpm", "--steps", "4",
                                                   "--bucket", "2"))
    yield base, service
    httpd.shutdown()


def test_healthz(server):
    base, _ = server
    info = _get(base + "/healthz")
    assert info["status"] == "ok" and info["card"] == "cpu"
    assert info["method"] == "dpm" and info["steps"] == 4
    assert info["bucket"] == 2 and info["img_size"] == 16 and info["mode"] == "bucket"
    assert info["attn_impl"] == "plain"  # the CPU's default
    assert "usage" in _get(base + "/")


def test_sample_roundtrip(server):
    base, _ = server
    code, resp = _post(base + "/sample", {"n": 3, "seed": 7})
    assert code == 200, resp
    assert len(resp["images"]) == 3 and resp["method"] == "dpm" and resp["steps"] == 4
    for b64 in resp["images"]:
        png = decode_png(base64.b64decode(b64))
        assert png["pixels"].shape == (16, 16, 3) and png["pixels"].dtype == np.uint8
    assert resp["elapsed_ms"] > 0


def test_sample_deterministic_per_seed(server):
    base, _ = server
    _, r1 = _post(base + "/sample", {"n": 1, "seed": 11})
    _, r2 = _post(base + "/sample", {"n": 1, "seed": 11})
    _, r3 = _post(base + "/sample", {"n": 1, "seed": 12})
    assert r1["images"] == r2["images"]
    assert r1["images"] != r3["images"]


@pytest.mark.parametrize("payload,match", [
    ({"n": 0}, "n must be"),
    ({"n": 65}, "n must be"),
    ({"n": 1, "class_id": 3}, "unconditional"),  # an unconditional model takes no class
    ([1, 2], "JSON object"),  # a malformed body gets a 400, not a dropped connection
    ({"n": 1, "seed": "not-an-int"}, "invalid literal"),
], ids=["n0", "n65", "class_id", "not_object", "bad_seed"])
def test_sample_validation(server, payload, match):
    base, _ = server
    code, resp = _post(base + "/sample", payload)
    assert code == 400 and match in resp["error"]


def test_string_numbers_are_coerced_and_unknown_paths_404(server):
    base, _ = server
    code, _ = _post(base + "/sample", {"n": "1", "seed": "7"})
    assert code == 200
    code, resp = _post(base + "/other", {"n": 1})
    assert code == 404 and "unknown" in resp["error"]


def test_png_is_the_jax_servers_quantization():
    """The PNG holds clip(img * 255) truncated to uint8, as the JAX server
    writes it; NaN goes to 0."""
    img = np.array([[[0.0, 0.5, 1.0], [1.2, -0.1, 0.999]]], np.float32)
    img = np.concatenate([img, [[[np.nan, 0.25, 0.75], [0.1, 0.2, 0.3]]]]).astype(np.float32)
    got = decode_png(base64.b64decode(serve.png_b64(img)))["pixels"]
    want = np.clip(np.nan_to_num(img) * 255.0, 0, 255).astype(np.uint8)
    assert np.array_equal(got, want)


def test_ddpm_is_the_default_method(cfg):
    """A deliberate difference: the JAX server defaults to DPM-Solver++ 20
    steps, the port's to the full reverse process; bench_serving follows."""
    from duodiff_tpu_torch.tools import bench_serving

    args = serve.get_args(["--config_path", str(cfg)])
    assert args.method == "ddpm" and args.device == "cuda" and args.attn_impl is None
    assert bench_serving.get_args(["--config_path", str(cfg)]).method == "ddpm"
    svc = serve.SamplerService(serve.get_args(base_flags(cfg)))
    assert svc.method == "ddpm" and svc.steps == 32


def test_ddpm_steps_contract(cfg):
    """--method ddpm refuses a --steps override (the full reverse process
    always runs; a shorter schedule changes the beta range)."""
    with pytest.raises(SystemExit, match="full reverse process"):
        serve.main(base_flags(cfg, "--method", "ddpm", "--steps", "4"))


@pytest.mark.parametrize("extra,match", [
    (["--model_parallel", "2", "--static_schedule", "31-0:3"],
     "--model_parallel does not combine with --static_schedule"),
    (["--static_schedule", "31-0:3", "--attn_impl", "fused_int8", "--int8_scales", "s.json"],
     "dynamic MLP scales"),
    (["--cache_every", "2", "--cache_pattern", "1,0"], "ONE of"),
    (["--method", "dpm", "--cache_pattern", "1,0"], "grid indices"),
    (["--cache_pattern", "0,1"], r"cache_pattern\[0\]"),
    (["--cache_pattern", "1,x"], "comma list"),
    (["--cache_outer", "1"], "requires --cache_every"),
    (["--method", "ddim", "--cache_every", "2"], "dpm/ddpm"),
    (["--cache_every", "0"], ">= 1"),
    (["--cache_every", "1", "--cache_outer", "2"], r"\[1, 1\]"),
    (["--method", "ddim", "--parametrization", "predict_original"], "predict_noise only"),
    (["--method", "dpm", "--parametrization", "predict_previous"], "predict_noise"),
    (["--guidance_scale", "2"], "null slot"),
], ids=["model_parallel", "int8_scales_static", "two_cache_rules", "pattern_dpm",
        "pattern_first", "pattern_parse", "cache_outer_alone", "cache_ddim", "cache_every_0",
        "cache_outer_range", "ddim_param", "dpm_param", "guidance_unconditional"])
def test_refusals(cfg, extra, match):
    with pytest.raises(SystemExit, match=match):
        serve.SamplerService(serve.get_args(base_flags(cfg, *extra)))


def test_refusals_without_a_checkpoint_or_a_card(cfg):
    with pytest.raises(SystemExit, match="checkpoint_path is required"):
        serve.SamplerService(serve.get_args(["--config_path", str(cfg), "--device", "cpu"]))
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            serve.SamplerService(serve.get_args(["--config_path", str(cfg), "--random_init"]))


def test_image_seed_and_label_stream():
    """The documented seed function of a request's image generators, and the
    labels' CPU generator seeded seed ^ 0x5EED."""
    assert serve.image_seed(7, 0) == 7 * 1_000_003
    assert serve.image_seed(7, 3) == 7 * 1_000_003 + 3
    assert serve.image_seed(-1, 0) == (-1_000_003) % 2**63
    want = torch.randint(0, 10, (4,), generator=torch.Generator().manual_seed(5 ^ 0x5EED))
    assert torch.equal(torch.randint(0, 10, (4,), generator=serve.label_generator(5)), want)


def test_conditional_unguided_server(cond_cfg):
    """Without guidance a conditional model's class_id is optional: omitted,
    random real labels from the request's seed, the same in both modes."""
    bucket = serve.SamplerService(serve.get_args(base_flags(cond_cfg, "--method", "dpm",
                                                            "--steps", "3")))
    r1 = bucket.sample(n=1, seed=3)
    r2 = bucket.sample(n=1, seed=3, class_id=7)
    assert not np.array_equal(r1[0], r2[0])  # other labels, same seed
    y = bucket._resolve_labels(3, None, 1)
    assert y.tolist() == torch.randint(0, 10, (1,), generator=serve.label_generator(3)).tolist()
    assert np.array_equal(bucket.sample(n=1, seed=3, class_id=int(y[0]))[0], r1[0])
    slots = serve.ContinuousSamplerService(serve.get_args(
        base_flags(cond_cfg, "--method", "dpm", "--steps", "3", "--slots", "2")))
    try:
        assert np.array_equal(slots.sample(n=1, seed=3)[0], r1[0])
    finally:
        slots.close()
    with pytest.raises(ValueError, match=r"class_id must be in \[0, 10\)"):
        bucket.sample(n=1, class_id=10)


def test_guided_server(cond_cfg):
    """--guidance_scale: one doubled forward; class_id is required and must
    be a real class (never the null slot)."""
    httpd, _, base = start_server(base_flags(cond_cfg, "--method", "dpm", "--steps", "3",
                                             "--guidance_scale", "2.5"))
    try:
        assert _get(base + "/healthz")["guidance_scale"] == 2.5
        code, resp = _post(base + "/sample", {"n": 1, "seed": 3, "class_id": 4})
        assert code == 200 and len(resp["images"]) == 1
        code, resp = _post(base + "/sample", {"n": 1})
        assert code == 400 and "class_id" in resp["error"]
        code, _ = _post(base + "/sample", {"n": 1, "class_id": 9})
        assert code == 400
    finally:
        httpd.shutdown()


def test_static_schedule_serving_matches_library(tmp_path):
    """--static_schedule: the bucket server runs the timestep-bucketed
    truncated backbones and gives make_static_exit_sampler's output from
    the image's own generator, bit for bit."""
    from duodiff_tpu_torch.diffusion.static_exit import (
        make_static_exit_sampler,
        parse_exit_schedule,
    )
    from duodiff_tpu_torch.utils.model_loading import load_model

    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(TINY_EE_YAML)
    spec = "11-6:1,5-0:3"
    flags = ["--config_path", str(cfg), "--random_init", "--device", "cpu", "--method", "ddpm",
             "--num_timesteps", "12", "--bucket", "2", "--static_schedule", spec]
    svc = serve.SamplerService(serve.get_args(flags))
    imgs = svc.sample(n=2, seed=3)
    assert len(imgs) == 2 and np.isfinite(np.stack(imgs)).all()
    model, _ = load_model(str(cfg), device=torch.device("cpu"), attn_impl="plain",
                          early_exit=True)
    model.eval().pack_for_kernels()
    sampler = make_static_exit_sampler(model, schedule=NoiseSchedule.create(steps=12),
                                       buckets=parse_exit_schedule(spec))
    with torch.inference_mode():
        want = sampler(torch.Generator().manual_seed(serve.image_seed(3, 0)), (2, 16, 16, 3))
    np.testing.assert_array_equal(np.stack(imgs), ((want + 1.0) / 2.0).numpy())
    cached = serve.SamplerService(serve.get_args(flags + ["--cache_every", "3"]))
    b = np.stack(cached.sample(n=2, seed=3))
    assert np.isfinite(b).all() and np.any(b != np.stack(imgs))


@pytest.mark.parametrize("extra,match", [
    (["--slots", "2"], "fixed-bucket only"),
    (["--method", "dpm", "--steps", "4"], "static-exit family"),
], ids=["slots", "dpm"])
def test_static_schedule_validation(tmp_path, extra, match):
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(TINY_EE_YAML)
    with pytest.raises(SystemExit, match=match):
        serve.make_service(serve.get_args(
            ["--config_path", str(cfg), "--random_init", "--device", "cpu",
             "--num_timesteps", "12", "--static_schedule", "11-0:3", *extra]))


def test_continuous_server_matches_bucket_server(cfg):
    """--slots serving returns the bucket-1 server's PNG bytes for the same
    (seed, n) requests, to the bit, and serves concurrent requests."""
    want1, want2 = served(cfg, ["--bucket", "1"], [{"n": 2, "seed": 7}, {"n": 1, "seed": 11}])
    httpd, _, base = start_server(base_flags(cfg, "--slots", "3", "--steps_per_poll", "2"))
    try:
        info = _get(base + "/healthz")
        assert info["mode"] == "continuous" and info["slots"] == 3 and info["method"] == "ddpm"
        results = {}

        def hit(name, payload):
            results[name] = _post(base + "/sample", payload)

        threads = [threading.Thread(target=hit, args=(name, payload)) for name, payload in
                   (("a", {"n": 2, "seed": 7}), ("b", {"n": 1, "seed": 11}),
                    ("c", {"n": 1, "seed": 11}))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert all(results[k][0] == 200 for k in "abc")
        assert results["a"][1]["images"] == want1
        assert results["b"][1]["images"] == want2 == results["c"][1]["images"]
        for b64 in want1:
            assert decode_png(base64.b64decode(b64))["pixels"].shape == (16, 16, 3)
        code, resp = _post(base + "/sample", {"n": 0})
        assert code == 400 and "error" in resp
        code, resp = _post(base + "/sample", {"n": 1, "class_id": 3})
        assert code == 400 and "error" in resp
    finally:
        httpd.shutdown()


@pytest.mark.parametrize("method", ["dpm", "ddim", "ddpm"])
def test_continuous_service_equals_bucket1_to_the_bit(cfg, method):
    """The service classes directly, float images: continuous == bucket 1."""
    steps = [] if method == "ddpm" else ["--steps", "5"]
    flags = base_flags(cfg, "--method", method, *steps)
    want = serve.SamplerService(serve.get_args(flags)).sample(n=3, seed=21)
    svc = serve.ContinuousSamplerService(serve.get_args(flags + ["--slots", "2",
                                                                 "--steps_per_poll", "3"]))
    try:
        got = svc.sample(n=3, seed=21)
    finally:
        svc.close()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_cached_serving_matches_bucket(cfg):
    """--cache_every: the continuous server gives the bucket-1 cached
    server's images (phase-aligned admissions keep the sequential cached
    trajectory), and caching changes them from dense."""
    ddpm = ["--num_timesteps", "31"]  # (steps - 1) % 3 == 0
    (dense,) = served(cfg, ddpm + ["--bucket", "1"], [{"n": 1, "seed": 5}])
    (want,) = served(cfg, ddpm + ["--bucket", "1", "--cache_every", "3"], [{"n": 2, "seed": 5}])
    (got,) = served(cfg, ddpm + ["--slots", "2", "--steps_per_poll", "2", "--cache_every", "3"],
                    [{"n": 2, "seed": 5}])
    assert got == want and got[0] != dense[0]
    (dpm_want,) = served(cfg, ["--method", "dpm", "--steps", "5", "--cache_every", "2"],
                         [{"n": 2, "seed": 5}])
    (dpm_got,) = served(cfg, ["--method", "dpm", "--steps", "5", "--cache_every", "2",
                              "--slots", "2"], [{"n": 2, "seed": 5}])
    assert dpm_got == dpm_want


def test_cache_schedule_serving_matches_uniform(cfg, tmp_path):
    """--cache_schedule (ddpm, fixed bucket): a table equal to the uniform
    anchors gives --cache_every's images; the unsupported modes (an
    aperiodic table in slots mode, dpm) are refused up front."""
    sched = tmp_path / "sched.json"
    save_cache_schedule(sched, uniform_table(2, 32))
    (want,) = served(cfg, ["--bucket", "1", "--cache_every", "2"], [{"n": 1, "seed": 9}])
    (got,) = served(cfg, ["--bucket", "1", "--cache_schedule", str(sched)], [{"n": 1, "seed": 9}])
    assert got == want
    # this uniform table anchors t % 2 == 0 but not t = 31, the first reverse
    # step: it cannot ride mixed-timestep slots
    with pytest.raises(SystemExit, match="fixed-bucket"):
        serve.ContinuousSamplerService(serve.get_args(
            base_flags(cfg, "--slots", "2", "--cache_schedule", str(sched))))
    with pytest.raises(SystemExit, match="grid indices"):
        serve.SamplerService(serve.get_args(
            base_flags(cfg, "--method", "dpm", "--steps", "4", "--cache_schedule", str(sched))))


def test_cache_pattern_serving_matches_bucket(cfg):
    """--cache_pattern: the continuous server and the fixed bucket (the
    pattern expanded to its absolute-t table) give the same images, and the
    pattern changes them from dense."""
    (dense,) = served(cfg, ["--bucket", "1"], [{"n": 1, "seed": 21}])
    (want,) = served(cfg, ["--bucket", "1", "--cache_pattern", "1,0,1,0"], [{"n": 2, "seed": 21}])
    (got,) = served(cfg, ["--slots", "2", "--steps_per_poll", "2", "--cache_pattern", "1,0,1,0"],
                    [{"n": 2, "seed": 21}])
    assert got == want and got[0] != dense[0]


def test_periodic_cache_schedule_rides_slots(cfg, tmp_path):
    """A --cache_schedule table that is wave-periodic folds to its pattern
    and serves in slots mode, equal to that --cache_pattern."""
    path = tmp_path / "periodic.json"
    save_cache_schedule(path, periodic_pattern_table(np.array([1, 0], bool), 32))
    slots = ["--slots", "2", "--steps_per_poll", "2"]
    (got,) = served(cfg, slots + ["--cache_schedule", str(path)], [{"n": 1, "seed": 4}])
    (want,) = served(cfg, slots + ["--cache_pattern", "1,0"], [{"n": 1, "seed": 4}])
    assert got == want


def test_continuous_service_failure_propagation(cfg):
    """A crash in the device-loop thread fails every waiting request (503
    over HTTP, the error through the future), never leaves one blocked;
    later requests are refused up front with 503, and /healthz answers 503
    with the stopped state and the error."""
    httpd, svc, base = start_server(base_flags(cfg, "--method", "dpm", "--steps", "4",
                                               "--slots", "2", "--steps_per_poll", "2"))
    try:
        code, resp = _post(base + "/sample", {"n": 1, "seed": 3})
        assert code == 200 and len(resp["images"]) == 1

        def boom():
            raise RuntimeError("injected device failure")

        svc.batcher.advance = boom
        code, resp = _post(base + "/sample", {"n": 2, "seed": 4})
        assert code == 503 and "injected device failure" in resp["error"]
        code, resp = _post(base + "/sample", {"n": 1, "seed": 5})
        assert code == 503 and "device loop failed" in resp["error"]
        assert "injected device failure" in resp["error"]
        with pytest.raises(RuntimeError, match="device loop failed"):
            svc.sample(n=1, seed=5)
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(base + "/healthz")
        info = json.loads(err.value.read())
        assert err.value.code == 503 and info["status"] == "stopped"
        assert "injected device failure" in info["error"]
    finally:
        httpd.shutdown()


def test_close_fails_queued_waiters(cfg):
    """close() resolves every waiter: a request still queued when the loop
    stops gets the shutdown error, not a hang."""
    svc = serve.ContinuousSamplerService(serve.get_args(
        base_flags(cfg, "--method", "dpm", "--steps", "4", "--slots", "1")))
    gate = threading.Event()
    inner = svc.batcher.advance

    def slow():
        gate.wait(timeout=60)
        inner()

    svc.batcher.advance = slow
    out = {}
    t = threading.Thread(target=lambda: out.setdefault("r", _capture(svc.sample, n=2, seed=1)))
    t.start()
    assert _wait_for(lambda: svc._slot_jobs)
    closer = threading.Thread(target=svc.close)
    closer.start()
    assert _wait_for(lambda: svc._stopped)
    gate.set()
    closer.join(timeout=60)
    t.join(timeout=60)
    assert not closer.is_alive() and not t.is_alive()
    assert isinstance(out["r"], RuntimeError) and "shutting down" in str(out["r"])


def _wait_for(cond, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)
    return True


def test_concurrent_requests_stress(cfg):
    """Many more client threads than cores against the continuous service,
    with a short switch interval: every request gets its own images (the
    bucket-1 server's for its seed) and the request count loses no update."""
    flags = base_flags(cfg, "--method", "dpm", "--steps", "3")
    bucket = serve.SamplerService(serve.get_args(flags))
    want = {seed: bucket.sample(n=2, seed=seed) for seed in range(12)}
    svc = serve.ContinuousSamplerService(serve.get_args(flags + ["--slots", "3",
                                                                 "--steps_per_poll", "2"]))
    got, interval = {}, sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def client(seed):
            got[seed] = svc.sample(n=2, seed=seed)

        clients = [threading.Thread(target=client, args=(seed,)) for seed in range(12)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=120)
        assert not any(c.is_alive() for c in clients)
    finally:
        sys.setswitchinterval(interval)
        svc.close()
    assert svc.requests_served == 12
    for seed in range(12):
        for g, w in zip(got[seed], want[seed]):
            np.testing.assert_array_equal(g, w)


def _capture(fn, **kw):
    try:
        return fn(**kw)
    except Exception as e:  # noqa: BLE001 — the test inspects it
        return e


def test_bench_serving_rehearsal(cfg, capsys):
    """tools/bench_serving on the CPU: both modes' JSON lines with the JAX
    tool's keys, and the ratio line."""
    from duodiff_tpu_torch.tools import bench_serving

    results = bench_serving.main(["--config_path", str(cfg), "--random_init", "--device", "cpu",
                                  "--method", "dpm", "--steps", "3", "--num_timesteps", "32",
                                  "--clients", "2", "--requests_per_client", "2", "--slots", "2"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    keys = {"mode", "clients", "requests", "throughput_img_s", "wall_s", "p50_ms", "p90_ms",
            "max_ms", "method", "steps", "cache_every"}
    assert [line.get("mode") for line in lines[:2]] == ["bucket", "continuous"]
    for line in lines[:2]:
        assert set(line) == keys and line["requests"] == 4 and line["throughput_img_s"] > 0
    assert set(lines[2]) == {"continuous_vs_bucket_throughput", "p50_latency_ratio"}
    assert results["ratio"] == lines[2]
