"""The port's measuring tools on the CPU: ``utils/profiling.py``,
``tools/microbench.py`` and ``tools/trace_step.py``.

- ``flops_per_uvit_forward`` equals the JAX package's exactly (integer
  arithmetic on both sides) on every config in ``configs/``;
- microbench's three parts run at a tiny config and batch 2 (times on the
  CPU are the host's and are not checked), and every row is there;
- ``--device cuda`` without CUDA and ``--rng rbg`` are refused;
- ``summarize`` on a hand-written Chrome trace gives the exact family
  totals, per-step time, top kernels and idle share (tolerance 1e-9
  relative: float sums of microseconds), reports a trace with no device
  events as such, and reads a ``train.py --profile`` trace.
"""

import json
import math
import os
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from duodiff_tpu.config import flagship_config as jax_flagship_config  # noqa: E402
from duodiff_tpu.config import load_model_config as jax_load_model_config  # noqa: E402
from duodiff_tpu.utils.profiling import flops_per_uvit_forward as jax_flops  # noqa: E402
from duodiff_tpu_torch.config import flagship_config, load_model_config  # noqa: E402
from duodiff_tpu_torch.data.synthetic import write_palette_cifar  # noqa: E402
from duodiff_tpu_torch.tools import microbench, trace_step  # noqa: E402
from duodiff_tpu_torch.utils import profiling  # noqa: E402

CPU = torch.device("cpu")
TINY = """model_params:
  img_size: 32
  patch_size: 8
  in_chans: 3
  embed_dim: 32
  depth: 3
  num_heads: 2
  mlp_ratio: 4
  qkv_bias: False
  mlp_time_embed: False
  num_classes: -1
  normalize_timesteps: True
"""
REL = 1e-9


@pytest.fixture
def tiny(tmp_path):
    path = tmp_path / "tiny.yaml"
    path.write_text(TINY)
    return str(path)


# --- utils/profiling.py ---------------------------------------------------------


@pytest.mark.parametrize("config", sorted(p.name for p in (REPO / "configs").glob("*.yaml")))
def test_flops_equal_jax_on_every_config(config):
    path = REPO / "configs" / config
    jax_cfg = jax_load_model_config(str(path))[0]
    cfg = load_model_config(path)
    for batch in (1, 128):
        assert profiling.flops_per_uvit_forward(cfg, batch) == jax_flops(jax_cfg, batch)


def test_flops_equal_jax_on_the_flagship():
    assert (profiling.flops_per_uvit_forward(flagship_config(), 128)
            == jax_flops(jax_flagship_config(), 128))


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(tmp_path / "t", CPU):
        torch.ones(8).sum()
    events = json.loads((tmp_path / "t" / profiling.TRACE_FILE).read_text())["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)


def test_step_timer_reports_each_window():
    timer = profiling.StepTimer(window=2)
    assert timer.tick() == {} and "steps_per_sec" in timer.tick()
    assert timer.tick() == {} and timer.tick()["steps_per_sec"] > 0


# --- tools/microbench.py --------------------------------------------------------


def test_microbench_forward_runs(tiny):
    times = microbench.bench_forward(tiny, device=CPU, batch=2, reps=1)
    assert sorted(times) == ["fused", "pallas", "xla"] and all(t > 0 for t in times.values())


def test_microbench_kernels_run():
    times = microbench.bench_kernels(device=CPU, batch=2, reps=1)
    assert list(times) == ["flash_attention", "fused_attn_sublayer", "Block[pallas]",
                           "Block[xla]", "Block[fused]"]
    assert all(t > 0 for t in times.values())


@pytest.mark.parametrize("model", ["uvit", "deediff"])
def test_microbench_train_runs(model, tiny, monkeypatch, capsys):
    monkeypatch.setenv("MB_CONFIG", tiny)
    if model == "deediff":
        monkeypatch.setenv("MB_MODEL", "deediff")
        monkeypatch.setenv("MB_ONLY", "fused")
    times = microbench.bench_train(device=CPU, batch=2, reps=1, warmup=1)
    losses = times.pop("train_loss")
    rows = (["fused+mlp:auto"] if model == "deediff" else
            ["fused+mlp:auto", "pallas+mlp:fused", "pallas+mlp:xla", "xla+mlp:xla"])
    assert list(times) == rows and all(t > 0 for t in times.values())
    assert list(losses) == rows and all(map(math.isfinite, losses.values()))
    out = capsys.readouterr().out
    assert "train_step[fused +mlp:auto ] gelu=exact" in out  # the JAX tool's row label
    assert "nan" not in out


def test_microbench_cli_runs_a_part(tiny, capsys):
    result = microbench.main(["fwd", tiny, "--device", "cpu"])
    assert sorted(result["fwd"]) == ["fused", "pallas", "xla"]
    assert "no card" in result["card"] and "forward[fused ]" in capsys.readouterr().out


@pytest.mark.parametrize("tool", ["microbench", "trace_step"])
def test_cuda_is_refused_without_a_card(tool):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: there is nothing to refuse")
    argv = ["fwd"] if tool == "microbench" else []
    with pytest.raises(SystemExit, match="no CUDA device"):
        {"microbench": microbench, "trace_step": trace_step}[tool].main(argv)


# --- tools/trace_step.py --------------------------------------------------------


def test_rbg_is_refused(capsys):
    with pytest.raises(SystemExit) as e:
        trace_step.get_args(["--rng", "rbg"])
    assert e.value.code == 2 and "one generator family" in capsys.readouterr().err


def _kernel(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7, "ts": ts, "dur": dur}


HAND_TRACE = [
    {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1, "tid": 1, "ts": 1000.0,
     "dur": 2000.0},  # the span: 1000 .. 3000 us
    {"ph": "i", "cat": "instant", "name": "mark", "pid": 1, "tid": 1, "ts": 500.0},
    _kernel("void duodiff::(anonymous namespace)::attn_core<true>(Params)", 1100.0, 100.0),
    _kernel("nvjet_tst_128x64_64x4_1x2_h_bz_TNT", 1150.0, 50.0),  # overlaps the one above
    _kernel("void duodiff::(anonymous namespace)::gemm_bf16_kernel<1>(Args)", 1300.0, 200.0),
    _kernel("void at::native::vectorized_elementwise_kernel<4, ...>", 1600.0, 30.0),
    _kernel("Memcpy HtoD (Pageable -> Device)", 1700.0, 20.0, cat="gpu_memcpy"),
    _kernel("void at::native::reduce_kernel<512, 1, ...>", 1800.0, 10.0),
    _kernel("Memset (Device)", 1900.0, 4.0, cat="gpu_memset"),
    _kernel("some_other_kernel", 2000.0, 6.0),
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1, "tid": 1,
     "ts": 1090.0, "dur": 5.0},
]


def test_summarize_a_hand_written_trace(tmp_path):
    (tmp_path / "trace.json").write_text(json.dumps({"traceEvents": HAND_TRACE}))
    got = trace_step.summarize(tmp_path, n_steps=4, top=3)
    assert got["device_events"] == 8 and got["span_ms"] == pytest.approx(2.0, rel=REL)
    # the union: 1100..1200 (the two overlapping kernels), then 200 + 30 + 20 + 10 + 4 + 6
    busy = (100 + 200 + 30 + 20 + 10 + 4 + 6) / 1e3
    assert got["busy_ms"] == pytest.approx(busy, rel=REL)
    assert got["per_step_ms"] == pytest.approx(busy / 4, rel=REL)
    assert got["idle_share"] == pytest.approx(1 - busy / 2.0, rel=REL)
    want = {"own kernels": 0.3, "cuBLAS matrix products": 0.05, "PyTorch elementwise": 0.03,
            "copies and memsets": 0.024, "PyTorch reductions": 0.01, "other": 0.006}
    assert got["families"].keys() == want.keys()
    for family, ms in want.items():
        assert got["families"][family] == pytest.approx(ms, rel=REL), family
    assert [name for name, _ in got["top"]] == [HAND_TRACE[i]["name"] for i in (4, 2, 3)]
    assert [ms for _, ms in got["top"]] == pytest.approx([0.2, 0.1, 0.05], rel=REL)


def test_summarize_without_device_events(tmp_path, capsys):
    host = [e for e in HAND_TRACE if e.get("cat") in ("cpu_op", "cuda_runtime", "instant")]
    (tmp_path / "trace.json").write_text(json.dumps({"traceEvents": host}))
    got = trace_step.summarize(tmp_path, n_steps=4)
    assert got["device_events"] == 0 and got["span_ms"] == pytest.approx(2.0, rel=REL)
    assert got["busy_ms"] is got["idle_share"] is got["families"] is None
    assert "not measured" in capsys.readouterr().out


def test_summarize_takes_the_newest_trace(tmp_path):
    old, new = tmp_path / "a" / "trace.json", tmp_path / "b" / "trace.json"
    for path, events in ((old, HAND_TRACE[:3]), (new, HAND_TRACE)):
        path.parent.mkdir()
        path.write_text(json.dumps({"traceEvents": events}))
    (tmp_path / "run_args.json").write_text(json.dumps({"lr": 1e-3}))  # not a trace
    os.utime(old, (1, 1))
    got = trace_step.summarize(tmp_path, n_steps=1)
    assert got["trace"] == str(new) and got["device_events"] == 8
    assert trace_step.summarize(old, n_steps=1)["device_events"] == 1
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "run_args.json").write_text("{}")
    with pytest.raises(FileNotFoundError, match="no Chrome trace"):
        trace_step.newest_trace(empty)


def test_summarize_reads_a_train_profile(tmp_path):
    """``train.py --profile`` writes the trace ``--summarize_only`` reads."""
    from duodiff_tpu_torch import train

    (tmp_path / "tiny.yaml").write_text(TINY)
    write_palette_cifar(tmp_path / "data", seed=0, per_batch=16)
    train.main(["--config_path", str(tmp_path / "tiny.yaml"), "--data_path",
                str(tmp_path / "data"), "--log_path", str(tmp_path / "logs"), "--exp_name", "p",
                "--n_steps", "4", "--batch_size", "4", "--profile", "--device", "cpu"])
    assert (tmp_path / "logs" / "p" / "profile" / "trace.json").exists()
    result = trace_step.main(["--summarize_only", "--out", str(tmp_path / "logs" / "p"),
                              "--steps", "2"])
    summary = result["summary"]
    assert summary["trace"].endswith("profile/trace.json") and summary["span_ms"] > 0
    assert summary["device_events"] == 0 and result["capture"] is None


@pytest.mark.parametrize("mode", ["sample", "train"])
def test_trace_step_captures_on_the_cpu(mode, tiny, tmp_path):
    result = trace_step.main(["--device", "cpu", "--config", tiny, "--batch", "2", "--steps",
                              "2", "--mode", mode, "--out", str(tmp_path / "tr")])
    assert result["launches"] == {} and "no card" in result["card"]
    assert result["capture"]["step_ms"] > 0
    assert result["summary"]["trace"] == str(tmp_path / "tr" / "trace.json")
    assert result["summary"]["span_ms"] > 0 and result["summary"]["busy_ms"] is None
