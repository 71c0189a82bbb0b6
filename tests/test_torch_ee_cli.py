"""The early-exit sampling CLI (``python -m duodiff_tpu_torch.eesample``)
and the probe-calibration tool (``python -m
duodiff_tpu_torch.tools.calibrate_probes``) on the CPU at a tiny config:
each route (dynamic, guided, int8 with static scales, static buckets
derived and given, block-cached by period and by table, adaptive monotone
and bidirectional on the tool's file) writes ``eesampler.py``'s files and
samples what the library functions sample from the same seed; every
refusal of ``eesampler.py`` and the port's own (``--model_parallel``,
``--int8_scales`` with the static and adaptive routes, no CUDA device)
writes nothing."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from duodiff_tpu.diffusion import calibration as jcal
from duodiff_tpu_torch import eesample
from duodiff_tpu_torch.diffusion.cache_schedule import save_cache_schedule
from duodiff_tpu_torch.diffusion.calibration import load_probe_calibration
from duodiff_tpu_torch.diffusion.sampling import early_exit_sample
from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
from duodiff_tpu_torch.diffusion.static_exit import static_exit_sample
from duodiff_tpu_torch.tools import calibrate_probes
from duodiff_tpu_torch.utils.model_loading import load_model

torch.set_num_threads(1)

STEPS, BATCH, DEPTH = 10, 2, 5
PARAMS = dict(img_size=16, patch_size=2, in_chans=3, embed_dim=32, depth=DEPTH, num_heads=4,
              mlp_ratio=4, qkv_bias=False, mlp_time_embed=False, normalize_timesteps=True)


def _write_config(path, **kw):
    lines = "".join(f"  {k}: {v!r}\n" if isinstance(v, str) else f"  {k}: {v}\n"
                    for k, v in {**PARAMS, **kw}.items())
    path.write_text("model_params:\n" + lines)
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("ee_cli")
    out = {
        "config": _write_config(root / "ee.yaml", num_classes=-1,
                                classifier_type="mlp_probe_per_layer"),
        "cond": _write_config(root / "ee_cond.yaml", num_classes=10,
                              classifier_type="attention_probe"),
        "root": root,
    }
    names = [f"in_blocks_{i}" for i in range(2)] + ["mid_block"] + [
        f"out_blocks_{i}" for i in range(2)]
    out["scales"] = root / "scales.json"
    out["scales"].write_text(json.dumps({"blocks": {n: [3.0, 2.5] for n in names}}))
    out["calibration"] = root / "calibration.json"
    result = calibrate_probes.main(["--device", "cpu", "--config", out["config"], "--batch", "2",
                                    "--steps", str(STEPS), "--out", str(out["calibration"])])
    out["tool"] = result
    return out


def _argv(files, folder, *extra, config="config"):
    return ["--device", "cpu", "--config_path", files[config], "--random_init",
            "--num_timesteps", str(STEPS), "--batch_size", str(BATCH), "--seed", "3",
            "--output_folder", str(folder), *extra]


def _check_files(folder: Path, result: dict) -> None:
    """eesampler.py's files: one PNG a sample, the statistics, and both
    diagnostics tables as .npy and .pt."""
    assert sorted(p.name for p in folder.glob("*.png")) == [f"{i}.png" for i in range(BATCH)]
    assert (folder / "statistics.txt").read_text().startswith("Elapsed time: ")
    err = np.load(folder / "error_prediction_by_timestep.npy")
    idx = np.load(folder / "indices_by_timestep.npy")
    assert err.shape == (STEPS, DEPTH) and idx.shape == (STEPS, BATCH)
    assert np.array_equal(err, result["err_by_t"], equal_nan=True)
    assert np.array_equal(idx, result["idx_by_t"]) and idx.min() >= 0 and idx.max() <= DEPTH
    pt_err = torch.load(folder / "error_prediction_by_timestep.pt")
    pt_idx = torch.load(folder / "indices_by_timestep.pt")
    assert pt_idx.dtype == torch.float32 and np.array_equal(pt_idx.numpy(), idx)
    assert np.array_equal(pt_err.numpy(), err, equal_nan=True)
    assert result["samples"].shape == (BATCH, 16, 16, 3) and np.isfinite(result["samples"]).all()


def _model(files, config="config", **kw):
    model, cfg = load_model(files[config], device="cpu", seed=3, early_exit=True, **kw)
    return model.eval(), cfg


def test_dynamic_route(files, tmp_path):
    """The CLI's samples and tables are early_exit_sample's from the same seed."""
    result = eesample.main(_argv(files, tmp_path, "--threshold", "0.5"))
    _check_files(tmp_path, result)
    model, cfg = _model(files)
    model.pack_for_kernels()
    generator = torch.Generator().manual_seed(3)
    with torch.inference_mode():
        x, err, idx = early_exit_sample(model, generator,
                                        schedule=NoiseSchedule.create(steps=STEPS),
                                        shape=(BATCH, 16, 16, 3), threshold=0.5)
    assert np.array_equal(result["samples"], ((x + 1) / 2).numpy())
    assert np.array_equal(result["idx_by_t"], idx.numpy())
    assert np.array_equal(result["err_by_t"], err.numpy())
    assert not (tmp_path / "adaptive_log.json").exists()


@pytest.mark.parametrize("route", ["dynamic", "static"])
def test_guided_routes(files, tmp_path, route):
    extra = (["--threshold", "0.0"] if route == "dynamic" else
             ["--static_schedule", "9-5:2,4-0:5"])
    result = eesample.main(_argv(files, tmp_path, *extra, "--class_id", "4",
                                 "--guidance_scale", "2.0", config="cond"))
    _check_files(tmp_path, result)
    if route == "static":
        assert (result["idx_by_t"][5:] == 2).all() and (result["idx_by_t"][:5] == 5).all()
        assert np.isnan(result["err_by_t"]).all()


def test_int8_dynamic_route_takes_the_scales(files, tmp_path):
    result = eesample.main(_argv(files, tmp_path, "--threshold", "0.5", "--attn_impl",
                                 "fused_int8", "--int8_scales", str(files["scales"])))
    _check_files(tmp_path, result)
    model, _ = _model(files, attn_impl="fused_int8", int8_scales=str(files["scales"]))
    assert [blk.int8_mlp_scales for blk in model.blocks()] == [(3.0, 2.5)] * DEPTH


@pytest.mark.parametrize("cache", ["none", "every", "table"])
def test_static_route_derived(files, tmp_path, cache):
    """--derive_schedule_from a dynamic run's table; the samples are
    static_exit_sample's on the derived buckets from the same seed."""
    dyn = tmp_path / "dyn"
    eesample.main(_argv(files, dyn, "--threshold", "0.497"))
    extra = ["--derive_schedule_from", str(dyn / "indices_by_timestep.npy"),
             "--derive_buckets", "3", "--derive_quantile", "0.9"]
    rule = None
    if cache == "every":
        extra += ["--cache_every", "2", "--cache_outer", "1"]
        rule = 2
    elif cache == "table":
        rule = np.zeros(STEPS, bool)
        rule[[8, 3]] = True
        save_cache_schedule(tmp_path / "anchors.json", rule)
        extra += ["--cache_schedule", str(tmp_path / "anchors.json")]
    out = tmp_path / "static"
    result = eesample.main(_argv(files, out, *extra))
    _check_files(out, result)
    from duodiff_tpu_torch.diffusion.static_exit import derive_exit_schedule

    buckets = derive_exit_schedule(np.load(dyn / "indices_by_timestep.npy"), 3, 0.9)
    assert len(buckets) > 1 and max(b[2] for b in buckets) > DEPTH // 2 + 1  # some cache
    for t_hi, t_lo, layer in buckets:
        assert (result["idx_by_t"][t_lo:t_hi + 1] == layer).all()
    model, _ = _model(files)
    model.pack_for_kernels()
    with torch.inference_mode():
        x = static_exit_sample(model, torch.Generator().manual_seed(3),
                               schedule=NoiseSchedule.create(steps=STEPS),
                               shape=(BATCH, 16, 16, 3), buckets=buckets, cache_every=rule,
                               cache_outer=1 if cache == "every" else None)
    assert np.array_equal(result["samples"], ((x + 1) / 2).numpy())


@pytest.mark.parametrize("walk", ["monotone", "bidirectional"])
def test_adaptive_route(files, tmp_path, walk):
    extra = ["--adaptive_layers", "1,3,5", "--adaptive_chunk", "4"]
    if walk == "monotone":
        extra += ["--threshold", "-1"]  # deepen at every chunk
    else:
        extra += ["--threshold", "1e6", "--adaptive_margin", "1.0", "--adaptive_bidirectional",
                  "--probe_calibration", str(files["calibration"])]  # shallower every chunk
    result = eesample.main(_argv(files, tmp_path, *extra))
    _check_files(tmp_path, result)
    log = json.loads((tmp_path / "adaptive_log.json").read_text())
    assert log == result["log"]
    assert [(r["t_hi"], r["t_lo"]) for r in log] == [(9, 6), (5, 2), (1, 0)]
    assert [r["layer"] for r in log] == ([1, 3, 5] if walk == "monotone" else [5, 3, 1])
    assert ("calibrated" in log[0]) == (walk == "bidirectional")
    err = result["err_by_t"]
    for row in log:  # only the layer's own probe slot was read
        slot = min(row["layer"], DEPTH - 1)
        rows = err[row["t_lo"]:row["t_hi"] + 1]
        assert np.allclose(rows[:, slot], row["mean_probe"])
        assert np.isnan(np.delete(rows, slot, axis=1)).all()


def test_calibration_tool(files):
    """The tool's file: JAX's reader takes it, its meta names the card line
    in place of a backend, and its numbers are the fit of the rows it
    returned."""
    from duodiff_tpu_torch.diffusion.calibration import fit_probe_calibration

    path, result = files["calibration"], files["tool"]
    calib = jcal.load_probe_calibration(path)
    assert calib == load_probe_calibration(path) and calib["unit"] == "mse_vs_backbone"
    assert calib["meta"]["card"] == result["card"] and calib["meta"]["steps"] == STEPS
    assert result["u_rows"].shape == result["e_rows"].shape == (STEPS, DEPTH)
    fit = fit_probe_calibration(result["u_rows"], result["e_rows"])
    assert {k: calib[k] for k in fit} == fit


# argv extras -> the refusal's message; none may write a sample
REFUSALS = {
    "no_checkpoint": (["--threshold", "0.5"], "--checkpoint_path is required"),
    "derive_and_static": (["--derive_schedule_from", "IDX", "--static_schedule", "9-0:1"],
                          "mutually exclusive"),
    "derive_length": (["--derive_schedule_from", "SHORT"], "covers 4 timesteps"),
    "no_threshold": ([], "--threshold is required"),
    "adaptive_and_static": (["--adaptive_layers", "1", "--static_schedule", "9-0:1"],
                            "--adaptive_layers and --static_schedule are mutually exclusive"),
    "adaptive_and_derived": (["--adaptive_layers", "1", "--derive_schedule_from", "IDX"],
                             "--adaptive_layers and --static_schedule are mutually exclusive"),
    "adaptive_cache": (["--adaptive_layers", "1", "--threshold", "1", "--cache_every", "2"],
                       "does not combine with block caching"),
    "adaptive_guided": (["--adaptive_layers", "1", "--threshold", "1", "--guidance_scale", "2"],
                        "--adaptive_layers does not combine with --guidance_scale"),
    "bidirectional_uncalibrated": (["--adaptive_layers", "1", "--threshold", "1",
                                    "--adaptive_bidirectional"], "needs --probe_calibration"),
    "cache_both": (["--static_schedule", "9-0:5", "--cache_every", "2", "--cache_schedule",
                    "x.json"], "--cache_schedule and --cache_every are mutually exclusive"),
    "cache_dynamic": (["--threshold", "1", "--cache_every", "2"],
                      "requires --static_schedule or --derive_schedule_from"),
    "cache_guided": (["--static_schedule", "9-0:5", "--cache_every", "2", "--guidance_scale",
                      "2"], "does not combine with --guidance_scale"),
    "cache_outer_alone": (["--static_schedule", "9-0:5", "--cache_outer", "1"],
                          "--cache_outer requires"),
    # ported since; one process is refused it, naming the torchrun launch it needs
    "model_parallel": (["--threshold", "1", "--model_parallel", "2"],
                       "does not divide 1 process: run under python -m torch.distributed.run"),
    "int8_scales_static": (["--static_schedule", "9-0:5", "--attn_impl", "fused_int8",
                            "--int8_scales", "SCALES"], "the dynamic-threshold route only"),
    "int8_scales_adaptive": (["--adaptive_layers", "1", "--threshold", "1", "--attn_impl",
                              "fused_int8", "--int8_scales", "SCALES"],
                             "the dynamic-threshold route only"),
    "guided_no_class": (["--threshold", "1", "--guidance_scale", "2"],
                        "--guidance_scale needs --class_id"),
    "guided_no_null_slot": (["--threshold", "1", "--guidance_scale", "2", "--class_id", "0",
                             "--null_class", "0"], "reserved null slot"),
    "guided_null_label": (["--threshold", "1", "--guidance_scale", "2", "--class_id", "9"],
                          "is not a real class"),
    "no_labels": (["--threshold", "1"], "needs labels"),
}
COND = {"guided_no_null_slot", "guided_null_label", "no_labels"}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusals(files, tmp_path, name):
    extra, message = REFUSALS[name]
    np.save(files["root"] / "idx.npy", np.zeros((STEPS, BATCH), np.int32))
    np.save(files["root"] / "short.npy", np.zeros((4, BATCH), np.int32))
    subst = {"IDX": str(files["root"] / "idx.npy"), "SHORT": str(files["root"] / "short.npy"),
             "SCALES": str(files["scales"])}
    extra = [subst.get(a, a) for a in extra]
    argv = _argv(files, tmp_path / "out", *extra, config="cond" if name in COND else "config")
    if name == "no_checkpoint":
        argv.remove("--random_init")
    with pytest.raises(SystemExit, match=message):
        eesample.main(argv)
    assert not list(tmp_path.rglob("*.png")) and not list(tmp_path.rglob("*.npy"))


def test_no_cuda_device_is_refused(files, tmp_path):
    """``--device`` defaults to cuda; without a card that is refused, never
    replaced by the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = _argv(files, tmp_path, "--threshold", "1")
    argv = argv[2:]  # drop --device cpu
    assert eesample.get_args(argv).device == "cuda"
    with pytest.raises(SystemExit, match="no CUDA device is available"):
        eesample.main(argv)
    with pytest.raises(SystemExit, match="no CUDA device is available"):
        calibrate_probes.main(["--config", files["config"], "--out", str(tmp_path / "c.json")])
    assert not list(tmp_path.iterdir())


def test_int8_scales_need_an_int8_block(files, tmp_path):
    with pytest.raises(ValueError, match="--int8_scales requires --attn_impl fused_int8"):
        eesample.main(_argv(files, tmp_path, "--threshold", "1", "--int8_scales",
                            str(files["scales"])))
