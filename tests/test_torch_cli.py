"""The sampling CLI's int8 and block-caching flags
(``python -m duodiff_tpu_torch.sample``, run in-process on the CPU at a
tiny config): W8A8 sublayers with a scales file, block-cached single-model
and DuoDiff runs, and the refusals ``sampler.py`` makes."""

import json

import numpy as np
import pytest
import torch

from duodiff_tpu_torch import sample

torch.set_num_threads(1)

SMALL = dict(img_size=16, patch_size=4, in_chans=3, embed_dim=64, num_heads=4, mlp_ratio=4)
STEPS = 8


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    out = {}
    for depth in (3, 5):
        path = d / f"tiny{depth}.yaml"
        path.write_text("model_params:\n" + "".join(
            f"  {k}: {v}\n" for k, v in dict(SMALL, depth=depth).items()))
        out[f"config{depth}"] = str(path)
        names = ([f"in_blocks_{i}" for i in range(depth // 2)] + ["mid_block"]
                 + [f"out_blocks_{i}" for i in range(depth // 2)])
        scales = d / f"scales{depth}.json"
        scales.write_text(json.dumps({"blocks": {n: [3.0, 1.0] for n in names}, "meta": {}}))
        out[f"scales{depth}"] = str(scales)
    schedule = d / "schedule.json"
    schedule.write_text(json.dumps({"num_timesteps": STEPS, "anchors": [0, 3]}))
    out["schedule"] = str(schedule)
    out["out"] = str(d / "out")
    return out


def _argv(files, *extra, late=True):
    argv = ["--device", "cpu", "--random_init", "--config_path", files["config3"],
            "--num_timesteps", str(STEPS), "--batch_size", "2",
            "--parametrization", "predict_noise", "--output_folder", files["out"]]
    if late:
        argv += ["--config_path_late", files["config5"], "--t_switch", "3"]
    return argv + list(extra)


def _run(argv):
    result = sample.main(argv)
    samples = np.load(f"{argv[argv.index('--output_folder') + 1]}/samples.npy")
    assert samples.shape == (2, 16, 16, 3) and samples.dtype == np.uint8
    assert np.isfinite(result["samples"]).all()
    return result["samples"]


@pytest.mark.parametrize("scales_flag", ["--int8_scales", "--int8_scales_late"])
def test_fused_int8_with_a_scales_file(files, scales_flag):
    scales = files["scales3"] if scales_flag == "--int8_scales" else files["scales5"]
    static = _run(_argv(files, "--attn_impl", "fused_int8", scales_flag, scales,
                        "--gelu_approx"))
    dynamic = _run(_argv(files, "--attn_impl", "fused_int8", "--gelu_approx"))
    assert not np.array_equal(static, dynamic)  # the scales reached the model


@pytest.mark.parametrize("rule", [("--cache_every", "2"), ("--cache_schedule", None)])
def test_cached_duodiff_run(files, rule):
    flag, value = rule
    cached = _run(_argv(files, flag, value or files["schedule"], "--attn_impl", "fused_int8"))
    dense = _run(_argv(files, "--attn_impl", "fused_int8"))
    assert not np.array_equal(cached, dense)


def test_cache_every_one_equals_dense(files):
    """Anchoring every step changes nothing: the cached DuoDiff run equals
    the dense one, and so does the single-model one."""
    np.testing.assert_array_equal(_run(_argv(files, "--cache_every", "1")), _run(_argv(files)))
    np.testing.assert_array_equal(_run(_argv(files, "--cache_every", "1", "--cache_outer", "1",
                                             late=False)),
                                  _run(_argv(files, late=False)))


REFUSALS = {
    "schedule_and_every": (SystemExit, "mutually exclusive",
                           lambda f: _argv(f, "--cache_schedule", f["schedule"],
                                           "--cache_every", "2")),
    "every_below_one": (SystemExit, "must be >= 1", lambda f: _argv(f, "--cache_every", "0")),
    "late_without_t_switch": (SystemExit, "needs --t_switch",
                              lambda f: _argv(f, "--cache_every", "2", late=False)
                              + ["--config_path_late", f["config5"]]),
    "outer_without_cache": (SystemExit, "requires --cache_every",
                            lambda f: _argv(f, "--cache_outer", "1")),
    "outer_out_of_range": (SystemExit, r"in \[1, 2\] for the late model's depth 5",
                           lambda f: _argv(f, "--cache_every", "2", "--cache_outer", "3")),
    "schedule_of_other_length": (ValueError, "num_timesteps",
                                 lambda f: _argv(f, "--cache_schedule", f["schedule"],
                                                 "--num_timesteps", str(STEPS + 1))),
    "scales_without_int8": (ValueError, "fused_int8",
                            lambda f: _argv(f, "--int8_scales", f["scales3"])),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusals(files, name):
    exc, match, argv = REFUSALS[name]
    with pytest.raises(exc, match=match):
        sample.main(argv(files))
