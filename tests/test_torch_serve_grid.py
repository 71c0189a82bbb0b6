"""``python -m duodiff_tpu_torch.serve`` over the process grid: JAX's five
``tests/test_serve_multichip.py`` cases on worlds of two gloo processes on
the CPU (tests/torch_dist_worker.start_world), over HTTP, against the
one-process server in this process:

- the bucket data-parallel (8 over 2 data ranks), DDPM and DPM-Solver++,
  equal to the bit (the PNG bytes);
- ``--model_parallel 2`` within 2 pixel levels (the sums run in another
  order);
- ``--slots 8`` over 2 data ranks equal to the bucket-1 server to the bit;
- ``--model_parallel`` with ``--static_schedule`` refused;

and ``/healthz``'s grid, and a follower killed mid-request: rank 0 answers
503, then ``/healthz`` 503 with status ``stopped``, not a hang.
"""

import base64
import contextlib
import json
import os
import re
import signal
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from torch_dist_worker import start_world, wait_world

from duodiff_tpu_torch import serve

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
TIMEOUT = 120  # seconds a world may take, start to end
DDPM = ["--method", "ddpm", "--num_timesteps", "12"]


@pytest.fixture(scope="module")
def cfg(tmp_path_factory):
    path = tmp_path_factory.mktemp("serve_grid") / "tiny.yaml"
    path.write_text(TINY_YAML)
    return path


def _flags(cfg, *extra):
    return ["--config_path", str(cfg), "--random_init", "--device", "cpu", "--no-warmup",
            *extra]


@contextlib.contextmanager
def serving_world(cfg, tmp_path, *extra, n: int = 2):
    """The server on an n-rank world; yields (base URL, the ranks, a dict
    that gets their exit codes and outputs). At the end rank 0 is
    interrupted, stops the followers and every rank must exit, within
    TIMEOUT in all."""
    ranks = start_world(n, ["-m", "duodiff_tpu_torch.serve", *_flags(cfg, *extra),
                            "--port", "0"], tmp_path)
    deadline = time.monotonic() + TIMEOUT
    ended = {}
    try:
        while not (found := re.search(r"serving on (http://[\d.]+:\d+)",
                                      ranks[0][1].read_text())):
            assert time.monotonic() < deadline and all(p.poll() is None for p, _ in ranks), \
                "\n".join(log.read_text()[-3000:] for _, log in ranks)
            time.sleep(0.05)
        yield found.group(1), ranks, ended
    finally:
        if ranks[0][0].poll() is None:
            ranks[0][0].send_signal(signal.SIGINT)
        ended["rcs"], ended["outs"] = wait_world(ranks, max(1.0, deadline - time.monotonic()),
                                                 "the server world")


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=TIMEOUT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _served(cfg, tmp_path, extra, requests):
    """/healthz and the PNGs of each request on a two-rank world."""
    with serving_world(cfg, tmp_path, *extra) as (base, _, ended):
        code, info = _get(base + "/healthz")
        assert code == 200, info
        images = []
        for payload in requests:
            code, resp = _post(base + "/sample", payload)
            assert code == 200, resp
            images.append(resp["images"])
    assert ended["rcs"] == [0, 0], "\n".join(o[-3000:] for o in ended["outs"])
    return info, images


def _one_process(cfg, extra, requests):
    """The PNGs of the one-process server for each request."""
    svc = serve.make_service(serve.get_args(_flags(cfg, *extra)))
    try:
        return [[serve.png_b64(im) for im in svc.sample(**payload)] for payload in requests]
    finally:
        svc.close()


def _pixels(pngs):
    from duodiff_tpu_torch.utils.image import decode_png

    return np.stack([decode_png(base64.b64decode(b))["pixels"] for b in pngs]).astype(np.int32)


@pytest.mark.parametrize("method", [
    ["--method", "ddpm", "--num_timesteps", "12"],
    ["--method", "dpm", "--steps", "4", "--num_timesteps", "32"],
], ids=["ddpm", "dpm"])
def test_bucket_data_parallel_equals_one_process(cfg, tmp_path, method):
    """Bucket 8 over 2 data ranks, 4 rows a rank: the PNG bytes of the
    one-process server, a request of a whole chunk and one of a part."""
    requests = [{"n": 8, "seed": 7}, {"n": 3, "seed": 2}]
    info, got = _served(cfg, tmp_path, [*method, "--bucket", "8"], requests)
    assert info["mesh"] == {"data": 2, "model": 1} and info["model_parallel"] == 1
    assert got == _one_process(cfg, [*method, "--bucket", "8"], requests)


def test_bucket_tensor_parallel_within_two_levels(cfg, tmp_path):
    requests = [{"n": 8, "seed": 5}]
    info, got = _served(cfg, tmp_path, [*DDPM, "--bucket", "8", "--model_parallel", "2"],
                        requests)
    assert info["mesh"] == {"data": 1, "model": 2} and info["model_parallel"] == 2
    assert info["attn_impl"] == "fused"
    want = _one_process(cfg, [*DDPM, "--bucket", "8"], requests)
    assert np.max(np.abs(_pixels(got[0]) - _pixels(want[0]))) <= 2


def test_slots_over_two_data_ranks_equal_bucket1(cfg, tmp_path):
    """--slots 8, 4 a rank: each request's images are the one-process
    bucket-1 server's."""
    requests = [{"n": 3, "seed": 7}, {"n": 1, "seed": 11}]
    info, got = _served(cfg, tmp_path, [*DDPM, "--slots", "8", "--steps_per_poll", "3"],
                        requests)
    assert info["mesh"] == {"data": 2, "model": 1} and info["mode"] == "continuous"
    assert got == _one_process(cfg, [*DDPM, "--bucket", "1"], requests)


def test_a_batch_that_does_not_divide_the_ranks_runs_whole_on_each(cfg, tmp_path):
    """Bucket 3 over 2 ranks: no grid in /healthz, the one-process images."""
    requests = [{"n": 3, "seed": 4}]
    info, got = _served(cfg, tmp_path, [*DDPM, "--bucket", "3"], requests)
    assert info["mesh"] is None and info["model_parallel"] == 1
    assert got == _one_process(cfg, [*DDPM, "--bucket", "3"], requests)


def test_model_parallel_with_static_schedule_is_refused(cfg):
    with pytest.raises(SystemExit, match="--model_parallel does not combine with "
                                         "--static_schedule"):
        serve.SamplerService(serve.get_args(_flags(cfg, *DDPM, "--bucket", "8",
                                                   "--model_parallel", "2",
                                                   "--static_schedule", "11-0:3")))


@pytest.mark.parametrize("mode", [["--bucket", "2"], ["--slots", "2"]], ids=["bucket", "slots"])
def test_a_dead_follower_gives_503_not_a_hang(cfg, tmp_path, mode):
    """The follower is killed while a long request runs: rank 0 answers it
    with 503, then /healthz with 503 and status stopped, then refuses."""
    with serving_world(cfg, tmp_path, "--method", "ddpm", "--num_timesteps", "2000",
                       *mode) as (base, ranks, ended):
        out = {}
        request = threading.Thread(target=lambda: out.update(r=_post(base + "/sample",
                                                                     {"n": 2, "seed": 1})))
        request.start()
        time.sleep(0.5)
        os.kill(ranks[1][0].pid, signal.SIGKILL)
        request.join(timeout=TIMEOUT)
        assert not request.is_alive()
        code, resp = out["r"]
        assert code == 503, resp
        code, info = _get(base + "/healthz")
        assert code == 503 and info["status"] == "stopped" and info["error"]
        code, resp = _post(base + "/sample", {"n": 1, "seed": 2})
        assert code == 503 and "stopped" in resp["error"]
    assert ended["rcs"][0] == 0, ended["outs"][0][-3000:]
