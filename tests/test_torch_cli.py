"""The sampling CLI's int8, block-caching and class flags
(``python -m duodiff_tpu_torch.sample``, run in-process on the CPU at a
tiny config): W8A8 sublayers with a scales file, block-cached single-model
and DuoDiff runs, class-conditional and guided runs through the unfused
block, and the refusals ``sampler.py`` makes."""

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


# --- class-conditional sampling ------------------------------------------------

CLASSES = 10


@pytest.fixture(scope="module")
def labelled(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_classes")
    out = {"out": str(d / "out")}
    for depth in (3, 5):
        path = d / f"classes{depth}.yaml"
        path.write_text("model_params:\n" + "".join(
            f"  {k}: {v}\n" for k, v in dict(SMALL, embed_dim=128, num_heads=2, depth=depth,
                                             num_classes=CLASSES).items()))
        out[f"config{depth}"] = str(path)
    return out


def _labelled_argv(labelled, *extra):
    return ["--device", "cpu", "--random_init", "--config_path", labelled["config3"],
            "--config_path_late", labelled["config5"], "--t_switch", "3",
            "--num_timesteps", str(STEPS), "--batch_size", "2",
            "--parametrization", "predict_noise", "--output_folder", labelled["out"], *extra]


@pytest.mark.parametrize("impl", ["pallas", "xla", "plain"])
def test_guided_run_with_scale_one_is_the_conditional_run(labelled, impl):
    """w = 1 reduces guidance to the conditional model, so the guided run of
    class 2 equals the unguided --fixed_class 2 run (same seed: no label is
    drawn in either) to the rounding of uncond + 1 * (cond - uncond)."""
    guided = _run(_labelled_argv(labelled, "--attn_impl", impl, "--class_id", "2",
                                 "--guidance_scale", "1.0"))
    fixed = _run(_labelled_argv(labelled, "--attn_impl", impl, "--fixed_class", "2"))
    np.testing.assert_allclose(guided, fixed, atol=1e-4)
    other = _run(_labelled_argv(labelled, "--attn_impl", impl, "--class_id", "2",
                                "--guidance_scale", "3.0"))
    assert not np.allclose(other, fixed, atol=1e-4)


def test_pallas_and_xla_blocks_sample_alike(labelled):
    """In fp32 the attention kernel's plain version and plain attention
    differ in summation order only."""
    argv = ["--class_id", "-1", "--guidance_scale", "1.5"]
    np.testing.assert_allclose(_run(_labelled_argv(labelled, "--attn_impl", "pallas", *argv)),
                               _run(_labelled_argv(labelled, "--attn_impl", "xla", *argv)),
                               atol=1e-3)


def test_random_labels_stay_inside_the_embedding_table(labelled):
    """Unguided --class_id draws in [1, min(1001, num_classes)); guided -1 in
    [0, null_class): never an index past the label embedding."""
    g = torch.Generator().manual_seed(0)
    args = sample.get_args(_labelled_argv(labelled, "--class_id", "0", "--batch_size", "512"))
    y, null = sample.class_labels(args, CLASSES, g)
    assert null is None and y.dtype == torch.long
    assert int(y.min()) == 1 and int(y.max()) == CLASSES - 1
    y, null = sample.class_labels(args, 2000, g)
    assert int(y.max()) <= 1000
    args = sample.get_args(_labelled_argv(labelled, "--class_id", "-1", "--guidance_scale", "2",
                                          "--batch_size", "512"))
    y, null = sample.class_labels(args, CLASSES, g)
    assert null == CLASSES - 1 and int(y.min()) == 0 and int(y.max()) == CLASSES - 2
    args.null_class = 5
    y, null = sample.class_labels(args, CLASSES, g)
    assert null == 5 and int(y.max()) == 4


CLASS_REFUSALS = {
    "no_labels": ([], "needs labels"),
    "fixed_with_class_id": (["--fixed_class", "1", "--class_id", "1"], "--fixed_class is the"),
    "fixed_with_guidance": (["--fixed_class", "1", "--guidance_scale", "2"],
                            "--fixed_class is the"),
    "fixed_out_of_range": (["--fixed_class", str(CLASSES)], r"must be in \[0, 10\)"),
    "guidance_without_labels": (["--guidance_scale", "2"], "needs --class_id"),
    "class_is_the_null_label": (["--class_id", "9", "--guidance_scale", "2"],
                                "not a real class"),
    "class_above_null_class": (["--class_id", "5", "--guidance_scale", "2", "--null_class", "4"],
                               "not a real class"),
    "null_class_out_of_range": (["--class_id", "1", "--guidance_scale", "2", "--null_class",
                                 str(CLASSES)], "not a label of this model"),
    "null_class_leaves_no_class": (["--class_id", "-1", "--guidance_scale", "2", "--null_class",
                                    "0"], "leaves no real classes"),
    "guidance_with_cache": (["--class_id", "1", "--guidance_scale", "2", "--cache_every", "2"],
                            "does not support --guidance_scale"),
}


@pytest.mark.parametrize("name", sorted(CLASS_REFUSALS))
def test_class_flag_refusals(labelled, name):
    extra, match = CLASS_REFUSALS[name]
    with pytest.raises(SystemExit, match=match):
        sample.main(_labelled_argv(labelled, *extra))


def test_class_id_on_an_unconditional_model_is_refused(files):
    with pytest.raises(SystemExit, match="class-conditional model"):
        sample.main(_argv(files, "--class_id", "1"))
