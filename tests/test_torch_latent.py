"""Latent diffusion in the port (the ImageNet-256 path) on the CPU at a tiny
latent config (16 x 16 x 4 latents of 32 x 32 images, the autoencoder of
``tests/models/test_autoencoder.py``'s ``TINY`` config, written as a
reference-named ``.pth`` from a JAX tree):

- the sampling CLI and ``eesample`` write the port's decode of the port's
  latents, bit for bit, and refuse a half-latent pair and a missing
  autoencoder file;
- the DuoDiff and early-exit trajectories on latents, each step's model
  output and the decoded images, against the JAX package's on one injected
  noise table (fp32, crossed-over weights);
- one training step with the encode against JAX's ``make_train_step`` on
  equal latents; the training CLI encodes every batch with the step's own
  draw, keeps the autoencoder out of the optimizer and the checkpoint, and a
  resumed run equals an unbroken one; its in-training samples are an RGBA
  grid of latents;
- the ImageNet-256 cache reader, and the two asset tools on a latent config.

Tolerances: trajectories and their decoded images 1e-4 (rtol and atol: ~1e-6
a forward, the ancestral updates, then the decode's fp32 convolutions in
another summation order); the encode 1e-5 of its largest value; the train
step's loss 1e-5 relative (a mean over 2,048 latent entries summed in
another order; measured 1.3e-6) and gradients rtol 1e-4 / atol 1e-6 (as
``test_torch_train_step.py``); the CLIs' outputs exact.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from duodiff_tpu.config import AutoencoderConfig as JaxAutoencoderConfig
from duodiff_tpu.config import UViTConfig as JaxConfig
from duodiff_tpu.diffusion import sampling as jsampling
from duodiff_tpu.diffusion.cache_schedule import load_cache_schedule as jax_load_cache_schedule
from duodiff_tpu.diffusion.schedule import NoiseSchedule as JaxSchedule
from duodiff_tpu.models.autoencoder import FrozenAutoencoderKL as JaxAutoencoder
from duodiff_tpu.models.autoencoder import init_autoencoder as jax_init_autoencoder
from duodiff_tpu.models.early_exit import EarlyExitUViT as JaxEarlyExitUViT
from duodiff_tpu.models.uvit import init_uvit as jax_init_uvit
from duodiff_tpu.training.train_state import make_train_step as jax_make_train_step
from duodiff_tpu.utils import image as jax_image
from duodiff_tpu_torch import eesample, sample, train
from duodiff_tpu_torch.config import AutoencoderConfig, UViTConfig
from duodiff_tpu_torch.data.datasets import NORMALIZE_OFFSET, NORMALIZE_SCALE, get_dataloader
from duodiff_tpu_torch.data.synthetic import write_palette_imagenet256_cache
from duodiff_tpu_torch.diffusion.sampling import ddpm_loop, duodiff_sample, early_exit_sample
from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
from duodiff_tpu_torch.models.autoencoder import FrozenAutoencoderKL
from duodiff_tpu_torch.models.early_exit import EarlyExitUViT
from duodiff_tpu_torch.models.uvit import UViT
from duodiff_tpu_torch.tools import calibrate_int8, derive_cache_schedule
from duodiff_tpu_torch.training.checkpointer import CHECKPOINT_FILE, Checkpointer
from duodiff_tpu_torch.training.train_state import make_train_step, step_generator
from duodiff_tpu_torch.training.trainer import ENCODE_STREAM
from duodiff_tpu_torch.utils import image
from duodiff_tpu_torch.utils.convert import (
    early_exit_state_dict_from_jax,
    export_autoencoder,
    uvit_state_dict_from_jax,
)
from duodiff_tpu_torch.utils.model_loading import load_autoencoder, load_model

torch.set_num_threads(1)

AE = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=4, embed_dim=4, resolution=32)
MODEL = dict(img_size=16, patch_size=2, in_chans=4, embed_dim=32, num_heads=4, mlp_ratio=4,
             qkv_bias=False, mlp_time_embed=False, normalize_timesteps=False)
STEPS, T_SWITCH, BATCH = 10, 4, 2
LATENT, IMAGE = (BATCH, 16, 16, 4), (BATCH, 32, 32, 3)
TOL = 1e-4


def _perturbed(params, seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.02 * rng.randn(*a.shape).astype(np.float32), params)


def _write_config(path, ae_path, **kw):
    lines = "".join(f"  {k}: {v!r}\n" if isinstance(v, str) else f"  {k}: {v}\n"
                    for k, v in {**MODEL, **kw}.items())
    block = "".join(f"  {k}: {list(v) if isinstance(v, tuple) else v}\n" for k, v in AE.items())
    path.write_text(f"model_params:\n{lines}\nautoencoder:\n  autoencoder_checkpoint_path: "
                    f"{ae_path}\n{block}")
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("latent")
    _, params = jax_init_autoencoder(JaxAutoencoderConfig(**AE), jax.random.PRNGKey(0),
                                     image_size=32)
    params = _perturbed(params, 0)
    ae_path = root / "ae.pth"
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in export_autoencoder(params).items()},
               ae_path)
    out = {"root": root, "ae_params": params, "ae_path": ae_path}
    for name, kw in {"l3": dict(depth=3, num_classes=-1), "l5": dict(depth=5, num_classes=-1),
                     "cond": dict(depth=3, num_classes=3),
                     "ee": dict(depth=5, num_classes=-1, classifier_type="mlp_probe_per_layer")
                     }.items():
        out[name] = _write_config(root / f"{name}.yaml", ae_path, **kw)
    plain = root / "pixels.yaml"
    plain.write_text("model_params:\n" + "".join(
        f"  {k}: {v}\n" for k, v in {**MODEL, "in_chans": 3, "depth": 3}.items()))
    out["pixels"] = str(plain)
    write_palette_imagenet256_cache(root / "data", n=24, num_classes=2, size=32)
    out["data"] = str(root / "data")
    return out


def _decoder(files, dtype=torch.bfloat16) -> FrozenAutoencoderKL:
    return load_autoencoder(files["ae_path"], AutoencoderConfig(**AE), dtype=dtype, device="cpu")


def _sample_argv(files, out, *extra, pair=True):
    argv = ["--device", "cpu", "--config_path", files["l3"], "--num_timesteps", str(STEPS),
            "--batch_size", str(BATCH), "--parametrization", "predict_noise", "--random_init",
            "--output_folder", str(out), "--seed", "4"]
    if pair:
        argv += ["--config_path_late", files["l5"], "--t_switch", str(T_SWITCH)]
    return argv + list(extra)


# --- the sampling CLIs decode what they sample ------------------------------------


@pytest.mark.parametrize("pair", [False, True])
def test_sample_cli_writes_the_decoded_latents(files, tmp_path, pair):
    result = sample.main(_sample_argv(files, tmp_path, "--timesteps_save", str(STEPS),
                                      pair=pair))
    models = []
    for config, seed in ((files["l3"], 4), (files["l5"], 5))[:1 + pair]:
        model, cfg = load_model(config, device="cpu", seed=seed)
        model.pack_for_kernels()
        models.append(model.eval())
    schedule = NoiseSchedule.create(steps=STEPS, device="cpu")
    with torch.no_grad():
        if pair:
            z = duodiff_sample(*models, torch.Generator().manual_seed(4), schedule=schedule,
                               shape=LATENT, t_switch=T_SWITCH)
        else:
            g = torch.Generator().manual_seed(4)
            z = ddpm_loop(models[0], schedule, "predict_noise", torch.randn(LATENT, generator=g),
                          g, range(STEPS - 1, -1, -1))
        want = ((_decoder(files).decode(z) + 1.0) / 2.0).numpy()
    assert result["samples"].shape == IMAGE and result["decode_seconds"] > 0
    np.testing.assert_array_equal(result["samples"], want)
    np.testing.assert_array_equal(result["intermediates"][STEPS], want)
    np.testing.assert_array_equal(np.load(tmp_path / "samples.npy"), image.to_uint8(want))
    for i in range(BATCH):
        png = np.asarray(Image.open(tmp_path / f"{i}.png"))
        np.testing.assert_array_equal(png, image.to_uint8(want[i]))


def test_eesample_writes_the_decoded_latents(files, tmp_path):
    threshold = 0.05
    result = eesample.main(["--device", "cpu", "--config_path", files["ee"], "--random_init",
                            "--threshold", str(threshold), "--num_timesteps", str(STEPS),
                            "--batch_size", str(BATCH), "--seed", "2", "--output_folder",
                            str(tmp_path)])
    model, _ = load_model(files["ee"], device="cpu", seed=2, early_exit=True)
    model.eval().pack_for_kernels()
    with torch.no_grad():
        z, _, idx = early_exit_sample(model, torch.Generator().manual_seed(2),
                                      schedule=NoiseSchedule.create(steps=STEPS, device="cpu"),
                                      shape=LATENT, threshold=threshold)
        want = ((_decoder(files).decode(z) + 1.0) / 2.0).numpy()
    np.testing.assert_array_equal(result["samples"], want)
    np.testing.assert_array_equal(result["idx_by_t"], idx.numpy())
    assert np.asarray(Image.open(tmp_path / "0.png")).shape == (32, 32, 3)


def test_a_half_latent_pair_is_refused(files, tmp_path):
    for early, late in ((files["l3"], files["pixels"]), (files["pixels"], files["l3"])):
        argv = _sample_argv(files, tmp_path, pair=False) + [
            "--config_path_late", late, "--t_switch", str(T_SWITCH)]
        argv[argv.index("--config_path") + 1] = early
        with pytest.raises(SystemExit, match="must share its sample space"):
            sample.main(argv)
    assert not list(tmp_path.glob("*.png"))


def test_a_missing_autoencoder_file_is_refused(files, tmp_path):
    config = _write_config(tmp_path / "missing.yaml", tmp_path / "none.pth", depth=3,
                           num_classes=3)
    with pytest.raises(FileNotFoundError, match="autoencoder_checkpoint_path"):
        sample.main(_sample_argv(files, tmp_path / "out", "--class_id", "1", pair=False)
                    + ["--config_path", config])
    with pytest.raises(FileNotFoundError, match="autoencoder_checkpoint_path"):
        train.main(_train_argv(files, "missing", 1) + ["--config_path", config])


# --- the trajectories against JAX ---------------------------------------------------


def _noise(seed=3):
    rng = np.random.RandomState(seed)
    table = rng.randn(STEPS, *LATENT).astype(np.float32)
    table[0] = 0.0
    return rng.randn(*LATENT).astype(np.float32), table


def _jax_decode(files, z):
    jmodel = JaxAutoencoder(config=JaxAutoencoderConfig(**AE))
    return np.asarray(jmodel.apply({"params": files["ae_params"]}, jnp.asarray(z),
                                   method=jmodel.decode))


def _uvit_pair(depth, seed):
    cfg = dict(MODEL, depth=depth, num_classes=-1)
    jmodel, params = jax_init_uvit(JaxConfig(**cfg), jax.random.PRNGKey(seed),
                                   dtype=jnp.float32)
    params = _perturbed(params, seed)
    model = UViT(UViTConfig(**cfg), dtype=torch.float32)
    model.load_state_dict(uvit_state_dict_from_jax(params), strict=True)
    model.pack_for_kernels()
    return jax.jit(lambda x, t, y: jmodel.apply({"params": params}, x, t, y)), model.eval()


def test_duodiff_latent_trajectory_matches_jax(files):
    """Each step's model output (the aux rows) and the state at the handoff
    and at the end, then both decodes (fp32)."""
    (j_early, early), (j_late, late) = _uvit_pair(3, 0), _uvit_pair(5, 1)
    x0, table = _noise()
    jsched, sched = JaxSchedule.create(steps=STEPS), NoiseSchedule.create(steps=STEPS)
    handoff = STEPS - T_SWITCH
    jx, tx = jnp.asarray(x0), torch.from_numpy(x0)
    for (japply, model), (hi, lo) in (((j_early, early), (STEPS - 1, handoff)),
                                      ((j_late, late), (handoff - 1, 0))):
        jx, _, jrows = jsampling.ddpm_scan(
            japply, jsched, "predict_noise", jx, jax.random.PRNGKey(0),
            jnp.arange(hi, lo - 1, -1), aux_fn=lambda out: (out, out),
            noise_table=jnp.asarray(table))
        with torch.no_grad():
            tx, rows = ddpm_loop(model, sched, "predict_noise", tx, None, range(hi, lo - 1, -1),
                                 noise_table=torch.from_numpy(table), aux_fn=lambda out: (out, out))
        assert rows.shape == (hi - lo + 1, *LATENT)
        np.testing.assert_allclose(rows.numpy(), np.asarray(jrows), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=TOL, atol=TOL)
    with torch.no_grad():
        got = _decoder(files, torch.float32).decode(tx).numpy()
    np.testing.assert_allclose(got, _jax_decode(files, np.asarray(jx)), rtol=TOL, atol=TOL)


def test_early_exit_latent_trajectory_matches_jax(files):
    cfg = dict(MODEL, depth=5, num_classes=-1, classifier_type="mlp_probe_per_layer")
    jmodel = JaxEarlyExitUViT(config=JaxConfig(**cfg))
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 4)), jnp.zeros((1,)), None))["params"]
    rng = np.random.RandomState(5)
    params = jax.tree_util.tree_map_with_path(
        lambda path, leaf: 0.05 * rng.randn(*leaf.shape).astype(np.float32)
        + (1.0 if path[-1].key == "scale" else 0.0), shapes)
    model = EarlyExitUViT(UViTConfig(**cfg), dtype=torch.float32)
    model.load_state_dict(early_exit_state_dict_from_jax(params, model.config), strict=True)
    model.eval().pack_for_kernels()
    x0, table = _noise(4)
    with torch.no_grad():
        u = model(torch.from_numpy(x0), torch.full((BATCH,), float(STEPS - 1)))[1].numpy()
    threshold = float(np.median(u))
    jx, _, jerr, jidx = jsampling.ee_scan(
        jax.jit(lambda x, t, y: jmodel.apply({"params": params}, x, t, y)),
        JaxSchedule.create(steps=STEPS), threshold, jnp.asarray(x0), jax.random.PRNGKey(0),
        jnp.arange(STEPS - 1, -1, -1), noise_table=jnp.asarray(table))
    with torch.no_grad():
        x, err, idx = early_exit_sample(model, None, schedule=NoiseSchedule.create(steps=STEPS),
                                        shape=LATENT, threshold=threshold,
                                        x_init=torch.from_numpy(x0),
                                        noise_table=torch.from_numpy(table))
        got = _decoder(files, torch.float32).decode(x).numpy()
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx)[::-1])
    np.testing.assert_allclose(err.numpy(), np.asarray(jerr)[::-1], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, _jax_decode(files, np.asarray(jx)), rtol=TOL, atol=TOL)


# --- training -----------------------------------------------------------------------


def test_train_step_with_encode_matches_jax(files):
    """The JAX trainer's order: encode the batch with the key fold_in(step
    key, 7), then the step. The port's encode on JAX's draw of that key gives
    JAX's latents; one step on them gives JAX's loss and gradients."""
    cfg = dict(MODEL, depth=3, num_classes=3)
    jmodel, params = jax_init_uvit(JaxConfig(**cfg), jax.random.PRNGKey(2), dtype=jnp.float32)
    params = _perturbed(params, 2)
    images = np.random.RandomState(6).uniform(-1, 1, IMAGE).astype(np.float32)
    labels = np.array([0, 2], np.int32)
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), 1), ENCODE_STREAM)
    jae = JaxAutoencoder(config=JaxAutoencoderConfig(**AE))
    jlatents = np.asarray(jae.apply({"params": files["ae_params"]}, jnp.asarray(images), key,
                                    method=jae.encode))
    ae = _decoder(files, torch.float32)
    with torch.no_grad():
        latents = ae.sample_latent(ae.encode_moments(torch.from_numpy(images)), noise=torch.from_numpy(
            np.array(jax.random.normal(key, LATENT, jnp.float32))))
    assert np.abs(latents.numpy() - jlatents).max() <= 1e-5 * np.abs(jlatents).max()

    jstep = jax_make_train_step(lambda p, x, t, y: jmodel.apply({"params": p}, x, t, y),
                                JaxSchedule.create(steps=1000), model_kind="uvit",
                                parametrization="predict_noise", has_labels=True)
    step_key = jax.random.PRNGKey(5)
    batch = {"image": jnp.asarray(jlatents), "label": jnp.asarray(labels)}
    (loss, _), grads = jax.value_and_grad(jstep.loss_fn, has_aux=True)(params, batch, step_key)
    want = uvit_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    model = UViT(UViTConfig(**cfg), dtype=torch.float32)
    model.load_state_dict(uvit_state_dict_from_jax(params), strict=True)
    step = make_train_step(model, NoiseSchedule.create(steps=1000),
                           parametrization="predict_noise", seed=0, has_labels=True)
    t_key, n_key = jax.random.split(step_key)
    timesteps = torch.from_numpy(np.array(jax.random.randint(t_key, (BATCH,), 0, 1000))).long()
    noise = torch.from_numpy(np.array(jax.random.normal(n_key, LATENT, jnp.float32)))
    metrics, got = step.backward({"image": torch.from_numpy(jlatents.copy()),
                                  "label": torch.from_numpy(labels).long()}, timesteps, noise)
    assert abs(metrics["train_loss"].item() / float(loss) - 1) <= 1e-5
    for (name, _), g in zip(model.named_parameters(), got):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def _train_argv(files, exp, n_steps, *extra):
    return ["--config_path", files["cond"], "--dataset", "imagenet256", "--device", "cpu",
            "--data_path", files["data"], "--log_path", str(files["root"] / "logs"),
            "--exp_name", exp, "--n_steps", str(n_steps), "--batch_size", "4",
            "--num_warmup_steps", "2", "--lr", "1e-3", "--seed", "0", "--num_timesteps", "20",
            "--label_dropout", "0.1", *extra]


def test_training_encodes_every_batch_with_its_own_draw(files):
    trainer = train.main(_train_argv(files, "encodes", 2))
    ae = trainer.autoencoder
    assert ae is not None and ae.dtype == torch.float32 and not ae.training
    assert all(not p.requires_grad for p in ae.parameters())
    model_params = {id(p) for p in trainer.model.parameters()}
    assert not {id(p) for p in ae.parameters()} & model_params
    assert set(trainer.state.optimizer.names) == {n for n, _ in trainer.model.named_parameters()}
    saved = Checkpointer.restore(trainer.log_path / "imagenet256_uvit_last")
    assert set(saved["model_state_dict"]) == set(trainer.model.state_dict())
    batch = trainer._to_device(trainer.dataloader.next_batch())
    assert batch["image"].shape == (4, 32, 32, 3)
    got = trainer._encode(batch, 7)["image"]
    with torch.no_grad():
        want = ae.encode(batch["image"], step_generator(0, 7, "cpu", ENCODE_STREAM))
    assert got.shape == (4, 16, 16, 4) and torch.equal(got, want)
    assert not torch.equal(got, trainer._encode(batch, 8)["image"])


def test_resumed_latent_run_equals_an_unbroken_one(files):
    whole = train.main(_train_argv(files, "whole", 4))
    train.main(_train_argv(files, "halves", 2))
    halves = train.main(_train_argv(files, "halves", 4, "--resume"))
    assert halves.start_step == 2
    assert whole.logs[-1]["train_loss"] == halves.logs[-1]["train_loss"]
    for a, b in zip(whole.model.state_dict().values(), halves.model.state_dict().values()):
        assert torch.equal(a, b)
    path = halves.log_path / "imagenet256_uvit_last" / CHECKPOINT_FILE
    model, _ = load_model(files["cond"], str(path), device="cpu", dtype=torch.float32)
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                  halves.model.state_dict().values()))


def test_in_training_samples_are_an_rgba_latent_grid(files):
    trainer = train.main(_train_argv(files, "grid", 2, "--log_every_n_steps", "2",
                                     "--n_samples", "3", "--sample_height", "16",
                                     "--sample_width", "16"))
    png = Image.open(trainer.log_path / "samples_step2.png")
    assert png.mode == "RGBA" and png.size == (32, 32)  # 2 x 2 cells of 16 x 16 latents


def test_rgba_png_matches_the_jax_writer(tmp_path):
    grid = image.make_grid(np.random.RandomState(7).uniform(-0.1, 1.1, (3, 8, 8, 4)))
    assert grid.shape == (16, 16, 4)
    image.save_image(grid, tmp_path / "port.png")
    jax_image.save_image(grid, tmp_path / "jax.png")
    ours, theirs = Image.open(tmp_path / "port.png"), Image.open(tmp_path / "jax.png")
    assert ours.mode == theirs.mode == "RGBA"
    np.testing.assert_array_equal(np.asarray(ours), np.asarray(theirs))
    np.testing.assert_array_equal(np.asarray(ours), image.to_uint8(grid))


# --- data and tools -----------------------------------------------------------------


def test_imagenet256_cache_is_read_as_jax_writes_it(tmp_path):
    cache = write_palette_imagenet256_cache(tmp_path, n=2)
    images = np.load(cache / "images.npy")
    assert images.dtype == np.uint8 and images.shape == (2, 256, 256, 3)
    assert json.loads((cache / "meta.json").read_text()) == {"shape": [2, 256, 256, 3]}
    assert (cache / "images.npy").stat().st_size < 2 * 196_608 + 256
    loader = get_dataloader("imagenet256", 2, 0, tmp_path)
    batch = loader.next_batch()
    loader.close()
    labels = np.load(cache / "labels.npy")
    want = images.astype(np.float32) * NORMALIZE_SCALE + NORMALIZE_OFFSET
    idx = [int(np.abs(want - b).max(axis=(1, 2, 3)).argmin()) for b in batch["image"]]
    assert sorted(idx) == [0, 1]
    np.testing.assert_allclose(batch["image"], want[idx], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(batch["label"], labels[idx])
    assert batch["image"].dtype == np.float32
    assert loader.dataset.num_real_classes == labels.max() + 1


def test_derive_cache_schedule_runs_on_a_latent_config(files, tmp_path):
    out = tmp_path / "schedule.json"
    result = derive_cache_schedule.main(
        ["--device", "cpu", "--config", files["l5"], "--shallow_config", files["l3"],
         "--t_switch", str(T_SWITCH), "--steps", str(STEPS), "--batch", "2", "--num_anchors",
         "3", "--out", str(out)])
    table = jax_load_cache_schedule(out, num_timesteps=STEPS)
    assert np.array_equal(table, result["table"]) and table[STEPS - T_SWITCH:].all()
    got = sample.main(_sample_argv(files, tmp_path / "s", "--cache_schedule", str(out)))
    assert got["samples"].shape == IMAGE and np.isfinite(got["samples"]).all()


def test_calibrate_int8_runs_on_a_latent_config(files, tmp_path):
    out = tmp_path / "scales.json"
    calibrate_int8.main(["--device", "cpu", "--config_path", files["l5"], "--random_init",
                         "--seed", "1", "--num_timesteps", "8", "--batch_size", "2",
                         "--mode", "amax", "--output", str(out)])
    assert sorted(json.loads(out.read_text())["blocks"]) == sorted(
        UViT(UViTConfig(**MODEL, depth=5)).block_names())
    got = sample.main(_sample_argv(files, tmp_path / "s", "--attn_impl", "fused_int8",
                                   "--int8_scales_late", str(out)))
    assert got["samples"].shape == IMAGE and np.isfinite(got["samples"]).all()
