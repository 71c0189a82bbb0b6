"""The training CLI (``python -m duodiff_tpu_torch.train``, run in-process on
the CPU at tiny configs) with ``--model deediff_uvit`` and the flags that
came with it: the JAX package's ``test_main_cli_train_deediff_frozen`` run
through the port, the in-training sampler's rows against the JAX trainer's
aux rows on one noise table, the early-exit checkpoint (names and values
those of ``export_early_exit_uvit``, loaded strictly by ``load_model`` and
sampled by ``eesample``), a resumed run equal to an unbroken one,
``--load_backbone`` and its refusals, ``--async_checkpoint``, ``--profile``,
and the CelebA cache read in the JAX package's order.

Tolerances: the sampler's rows and samples against JAX's 1e-4 (rtol and
atol, the trajectory bound of ``tests/test_torch_sampling.py``); the rest is
the port against itself, bit for bit."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duodiff_tpu.config import UViTConfig as JaxConfig
from duodiff_tpu.data.cache import MemmapCachedDataset as JaxCachedDataset
from duodiff_tpu.data.loader import DataLoader as JaxDataLoader
from duodiff_tpu.data.sampler import ResumableSeedableSampler as JaxSampler
from duodiff_tpu.diffusion.sampling import ddpm_scan
from duodiff_tpu.diffusion.schedule import NoiseSchedule as JaxSchedule
from duodiff_tpu.models.early_exit import EarlyExitUViT as JaxEarlyExitUViT
from duodiff_tpu.models.uvit import UViT as JaxUViT
from duodiff_tpu.utils.torch_export import export_early_exit_uvit
from duodiff_tpu_torch import eesample, train
from duodiff_tpu_torch.config import UViTConfig
from duodiff_tpu_torch.data.cache import CACHE_DIR, CELEBA_KEY
from duodiff_tpu_torch.data.datasets import get_dataloader
from duodiff_tpu_torch.data.synthetic import write_palette_celeba_cache, write_palette_cifar
from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
from duodiff_tpu_torch.models.early_exit import CLASSIFIER_TYPES, EarlyExitUViT
from duodiff_tpu_torch.models.uvit import UViT
from duodiff_tpu_torch.training.checkpointer import CHECKPOINT_FILE, Checkpointer
from duodiff_tpu_torch.training.trainer import sample_rows
from duodiff_tpu_torch.utils import convert
from duodiff_tpu_torch.utils.image import PNG_SIGNATURE
from duodiff_tpu_torch.utils.model_loading import load_model

torch.set_num_threads(1)

TINY = dict(img_size=32, patch_size=4, in_chans=3, embed_dim=32, depth=3, num_heads=4,
            mlp_ratio=4, qkv_bias=False, mlp_time_embed=False, num_classes=-1,
            normalize_timesteps=True, classifier_type="mlp_probe_per_layer")
TOL = 1e-4


def _write_config(path, **overrides):
    path.write_text("model_params:\n" + "".join(
        f"  {k}: {v!r}\n" if isinstance(v, str) else f"  {k}: {v}\n"
        for k, v in dict(TINY, **overrides).items()))
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("ee_train")
    write_palette_cifar(d / "data", seed=0, per_batch=16)
    write_palette_celeba_cache(d / "data", n=24, seed=0)
    return {"data": str(d / "data"), "logs": str(d / "logs"), "dir": d,
            "config": _write_config(d / "tiny.yaml"),
            "uvit_config": _write_config(d / "tiny_uvit.yaml"),
            "celeba_config": _write_config(d / "celeba.yaml", img_size=64, patch_size=16)}


def _argv(files, exp, n_steps, *extra):
    return ["--config_path", files["config"], "--model", "deediff_uvit", "--device", "cpu",
            "--data_path", files["data"], "--log_path", files["logs"], "--exp_name", exp,
            "--n_steps", str(n_steps), "--batch_size", "4", "--num_warmup_steps", "1",
            "--lr", "1e-3", "--seed", "0", *extra]


def _checkpoint(trainer, suffix="last"):
    return trainer.log_path / f"{trainer.args.dataset}_{trainer.args.model}_{suffix}"


def test_deediff_frozen_cli_logs_samples(files):
    """The JAX package's test_main_cli_train_deediff_frozen, its flags and
    checks, through the port; the backbone stays what it was built as."""
    trainer = train.main(_argv(files, "t2", 2, "--freeze_backbone", "--num_timesteps", "50",
                               "--log_every_n_steps", "2", "--n_samples", "2",
                               "--sample_height", "32", "--sample_width", "32"))
    logs = trainer.logs
    assert logs and "classifier_train_loss" in logs[-1]
    run = trainer.log_path
    rows = np.load(run / "sample_classifier_outputs_step2.npy")
    assert rows.shape == (50, 3, 2) and rows.dtype == np.float32 and np.isfinite(rows).all()
    srows = np.load(run / "sample_stats_step2.npy")
    assert srows.shape == (50, 2) and np.isfinite(srows).all()
    assert (run / "samples_step2.png").read_bytes().startswith(PNG_SIGNATURE)
    metrics = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    sampled = [m for m in metrics if "sample_mean_probe_error" in m]
    assert len(sampled) == 1 and sampled[0]["step"] == 2
    assert sampled[0]["sample_mean_probe_error"] == pytest.approx(float(rows.mean()), rel=1e-6)
    fresh, _ = load_model(files["config"], device="cpu", seed=0, early_exit=True)
    for (name, a), b in zip(fresh.uvit.state_dict().items(),
                            trainer.model.uvit.state_dict().values()):
        assert torch.equal(a, b), name


# --- the in-training sampler against the JAX trainer's ------------------------


def _jax_params(jmodel, shape, seed):
    x = jnp.zeros((1, *shape[1:]), jnp.float32)
    tree = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), x, jnp.zeros((1,))))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        value = 0.05 * rng.randn(*leaf.shape).astype(np.float32)
        return value + 1.0 if path[-1].key == "scale" else value

    return jax.tree_util.tree_map_with_path(draw, tree["params"])


@pytest.mark.parametrize("model_kind", ["uvit", "deediff_uvit"])
def test_sample_rows_match_the_jax_trainers_aux(model_kind):
    """sample_rows against ddpm_scan with the JAX trainer's apply and aux
    functions (``Trainer._log_samples``), variance beta, on one noise table."""
    steps, shape = 10, (2, 16, 16, 3)
    cfg = dict(TINY, img_size=16)
    early_exit = model_kind == "deediff_uvit"
    jmodel = (JaxEarlyExitUViT if early_exit else JaxUViT)(config=JaxConfig(**cfg))
    params = _jax_params(jmodel, shape, seed=3)
    config = UViTConfig(**cfg)
    if early_exit:
        model = EarlyExitUViT(config, dtype=torch.float32, attn_impl="plain")
        model.load_state_dict(convert.early_exit_state_dict_from_jax(params, config))
    else:
        model = UViT(config, dtype=torch.float32, attn_impl="plain")
        model.load_state_dict(convert.uvit_state_dict_from_jax(params))
    model.eval().pack_for_kernels()
    rng = np.random.RandomState(4)
    x0 = rng.randn(*shape).astype(np.float32)
    table = rng.randn(steps, *shape).astype(np.float32)

    def stats(o):
        return jnp.stack([jnp.mean(o.astype(jnp.float32)), jnp.std(o.astype(jnp.float32))])

    aux_fn = ((lambda out: (out[0], (jnp.asarray(out[1]), stats(out[0])))) if early_exit
              else (lambda out: (out, stats(out))))
    want_x, _, want_aux = ddpm_scan(
        lambda x, t, y: jmodel.apply({"params": params}, x, t, y), JaxSchedule.create(steps=steps),
        "predict_noise", jnp.asarray(x0), jax.random.PRNGKey(0), jnp.arange(steps - 1, -1, -1),
        variance_mode="beta", aux_fn=aux_fn, noise_table=jnp.asarray(table))
    with torch.inference_mode():
        x, probe_rows, stat_rows = sample_rows(model, NoiseSchedule.create(steps=steps),
                                               torch.from_numpy(x0), None,
                                               noise_table=torch.from_numpy(table))
    want_probes, want_stats = want_aux if early_exit else (None, want_aux)
    np.testing.assert_allclose(x.numpy(), np.asarray(want_x), rtol=TOL, atol=TOL)
    assert stat_rows.shape == (steps, 2)
    np.testing.assert_allclose(stat_rows.numpy(), np.asarray(want_stats), rtol=TOL, atol=TOL)
    if early_exit:
        assert probe_rows.shape == (steps, 3, 2)
        np.testing.assert_allclose(probe_rows.numpy(), np.asarray(want_probes), rtol=TOL,
                                   atol=TOL)
    else:
        assert probe_rows is None


# --- the checkpoint -------------------------------------------------------------


@pytest.mark.parametrize("kind", CLASSIFIER_TYPES)
def test_reference_names_equal_the_export(kind):
    """The port's state dict under the reference's names equals
    export_early_exit_uvit's on the same weights, name by name, shape and
    bits; and gathers back to the port's."""
    cfg = dict(TINY, img_size=16, classifier_type=kind)
    jmodel = JaxEarlyExitUViT(config=JaxConfig(**cfg))
    params = _jax_params(jmodel, (1, 16, 16, 3), seed=CLASSIFIER_TYPES.index(kind))
    config = UViTConfig(**cfg)
    state = convert.early_exit_state_dict_from_jax(params, config)
    got = convert.early_exit_state_dict_to_reference(state, config)
    want = export_early_exit_uvit(params)
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        value = np.asarray(value)
        assert got[name].dtype == torch.float32 and tuple(got[name].shape) == value.shape, name
        assert np.array_equal(got[name].numpy(), value), name
    back = convert.early_exit_state_dict_from_reference(got, config)
    assert sorted(back) == sorted(state)
    for name in state:
        assert torch.equal(back[name], state[name]), name
    with pytest.raises(KeyError, match="not an early-exit state dict"):
        convert.early_exit_state_dict_to_reference({**state, "extra": torch.zeros(1)}, config)


def test_trained_checkpoint_loads_strictly_and_samples(files, tmp_path):
    trainer = train.main(_argv(files, "to_sample", 3, "--ema_decay", "0.9"))
    path = _checkpoint(trainer) / CHECKPOINT_FILE
    saved = torch.load(path, map_location="cpu", weights_only=True)
    want = convert.early_exit_state_dict_to_reference(trainer.model.state_dict(),
                                                      trainer.model_config)
    assert sorted(saved["model_state_dict"]) == sorted(want)
    assert sorted(saved["ema_state_dict"]) == sorted(want)
    assert any(k.startswith("in_blocks_heads.") for k in want) and "matrix.0.classifier.0.weight" in want
    trainer.model.eval().pack_for_kernels()
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    t = torch.tensor([10.0, 900.0])
    for use_ema in (False, True):
        model, cfg = load_model(files["config"], str(path), device="cpu", dtype=torch.float32,
                                early_exit=True, use_ema=use_ema)
        assert isinstance(model, EarlyExitUViT) and cfg.classifier_type == "mlp_probe_per_layer"
        if use_ema:
            for name, p in model.named_parameters():
                assert torch.equal(p.detach(), trainer.state.ema[name]), name
            continue
        model.eval().pack_for_kernels()
        with torch.no_grad():
            for a, b in zip(model(x, t), trainer.model(x, t)):
                assert torch.equal(a, b)
    out = eesample.main(["--device", "cpu", "--config_path", files["config"],
                         "--checkpoint_path", str(path), "--threshold", "0.5",
                         "--num_timesteps", "5", "--batch_size", "2",
                         "--output_folder", str(tmp_path)])
    assert out["samples"].shape == (2, 32, 32, 3) and np.isfinite(out["samples"]).all()


def _final_state(trainer):
    return (trainer.model.state_dict(), trainer.state.optimizer.state_dict(), trainer.state.ema,
            trainer.dataloader.get_state())


def _assert_same_state(a, b):
    for x, y in zip(a[0].values(), b[0].values()):
        assert torch.equal(x, y)
    assert a[1]["count"] == b[1]["count"]
    for key in ("mu", "nu"):
        assert sorted(a[1][key]) == sorted(b[1][key])
        for name in a[1][key]:
            assert torch.equal(a[1][key][name], b[1][key][name]), name
    for name in a[2]:
        assert torch.equal(a[2][name], b[2][name]), name
    np.testing.assert_array_equal(a[3]["perm"], b[3]["perm"])
    assert a[3]["perm_index"] == b[3]["perm_index"]


@pytest.mark.parametrize("frozen", [False, True], ids=["trained", "frozen"])
def test_resumed_run_equals_an_unbroken_one(files, frozen):
    # the warm-up covers the first run's steps, so its learning rates are
    # those of the longer run
    extra = ("--ema_decay", "0.9", "--save_every_n_steps", "2", "--num_warmup_steps", "3"
             ) + ("--freeze_backbone",) * frozen
    whole = _final_state(train.main(_argv(files, f"whole{frozen}", 6, *extra)))
    first = train.main(_argv(files, f"halves{frozen}", 3, *extra))
    assert first.logs[-1]["step"] == 3
    second = train.main(_argv(files, f"halves{frozen}", 6, "--resume", *extra))
    assert second.start_step == 3
    _assert_same_state(whole, _final_state(second))
    assert all(not n.startswith("uvit.") for n in whole[1]["mu"]) == frozen


# --- --load_backbone ----------------------------------------------------------------


@pytest.mark.parametrize("source", ["pth", "uvit_run", "deediff_run"])
def test_load_backbone_fills_the_backbone(files, tmp_path, source):
    """A reference-format .pth of a plain U-ViT, a U-ViT run's checkpoint
    directory, or an early-exit run's .pth fill the backbone; frozen, it
    stays those weights bit for bit."""
    if source == "pth":
        want = load_model(files["uvit_config"], device="cpu", seed=5)[0].state_dict()
        path = tmp_path / "uvit.pth"
        torch.save({"model_state_dict": want}, path)
    elif source == "uvit_run":
        run = train.main(["--config_path", files["uvit_config"], "--device", "cpu",
                          "--data_path", files["data"], "--log_path", files["logs"],
                          "--exp_name", "backbone_src", "--n_steps", "1", "--batch_size", "4",
                          "--seed", "3"])
        want, path = run.model.state_dict(), _checkpoint(run)
    else:
        run = train.main(_argv(files, "ee_src", 1, "--seed", "4"))
        want, path = run.model.uvit.state_dict(), _checkpoint(run) / CHECKPOINT_FILE
    trainer = train.main(_argv(files, f"load_{source}", 2, "--load_backbone", str(path),
                               "--freeze_backbone"))
    got = trainer.model.uvit.state_dict()
    assert sorted(got) == sorted(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name


def _backbone_file(files, tmp_path, edit):
    state = load_model(files["uvit_config"], device="cpu", seed=5)[0].state_dict()
    edit(state)
    path = tmp_path / "edited.pth"
    torch.save(state, path)
    return str(path)


LOAD_REFUSALS = {
    "missing_key": (lambda s: s.pop("mid_block.mlp.fc1.weight"), KeyError,
                    "no 'mid_block.mlp.fc1.weight'"),
    "shape": (lambda s: s.update(pos_embed=torch.zeros(1, 5, 32)), ValueError,
              "'pos_embed' has shape"),
    "unexpected_key": (lambda s: s.update(extra=torch.zeros(1)), KeyError, "extra"),
}


@pytest.mark.parametrize("name", [*LOAD_REFUSALS, "orbax_dir", "plain_model"])
def test_load_backbone_refusals(files, tmp_path, name):
    if name in LOAD_REFUSALS:
        edit, error, message = LOAD_REFUSALS[name]
        argv = _argv(files, "refused", 1, "--load_backbone", _backbone_file(files, tmp_path, edit))
    elif name == "orbax_dir":
        (tmp_path / "orbax").mkdir()
        error, message = ValueError, "Orbax checkpoint, which needs JAX"
        argv = _argv(files, "refused", 1, "--load_backbone", str(tmp_path / "orbax"))
    else:
        error, message = ValueError, "--load_backbone applies to --model deediff_uvit only"
        argv = _argv(files, "refused", 1, "--load_backbone", "x.pth", "--model", "uvit")
    with pytest.raises(error, match=message):
        train.main(argv)


# --- --async_checkpoint and --profile --------------------------------------------------


def test_async_checkpoint_files_equal_synchronous_ones_and_resume(files):
    extra = ("--ema_decay", "0.9", "--save_every_n_steps", "2", "--save_new_every_n_steps", "2",
             "--num_warmup_steps", "4")
    sync = train.main(_argv(files, "sync", 4, *extra))
    async_run = train.main(_argv(files, "async", 4, "--async_checkpoint", *extra))
    for suffix in ("last", "step-2", "step-4"):
        a = Checkpointer.restore(_checkpoint(sync, suffix))
        b = Checkpointer.restore(_checkpoint(async_run, suffix))
        assert (_checkpoint(sync, suffix) / CHECKPOINT_FILE).read_bytes() == (
            _checkpoint(async_run, suffix) / CHECKPOINT_FILE).read_bytes()
        assert a["step"] == b["step"]
        for key in ("model_state_dict", "ema_state_dict"):
            for name in a[key]:
                assert torch.equal(a[key][name], b[key][name]), (suffix, key, name)
    resumed = train.main(_argv(files, "async", 6, "--async_checkpoint", "--resume", *extra))
    assert resumed.start_step == 4
    whole = train.main(_argv(files, "sync6", 6, *extra))
    _assert_same_state(_final_state(whole), _final_state(resumed))


def test_async_save_keeps_the_values_it_was_given(tmp_path):
    """The tensors are copied before save returns: changing them afterwards,
    while the writer thread may still run, changes nothing on disk."""
    ckpt = Checkpointer(tmp_path, "run", save_name="x", async_save=True)
    weights = {"w": torch.arange(6.0)}
    path = ckpt.save(step=1, model_state=weights)
    weights["w"].add_(100.0)
    ckpt.close()
    assert torch.equal(Checkpointer.restore(path)["model_state_dict"]["w"], torch.arange(6.0))
    ckpt.close()  # idempotent


def test_profile_writes_a_trace(files):
    trainer = train.main(_argv(files, "profiled", 10, "--profile"))
    trace = trainer.log_path / "profile" / "trace.json"
    events = json.loads(trace.read_text())["traceEvents"]
    assert events and trainer.logs[-1]["step"] == 10


# --- CelebA from its cache ------------------------------------------------------------


class _FloatFaces:
    """A stand-in for the JAX package's CelebA dataset: float32 HWC items in
    0..255, label 0, and the normalising transform."""

    scale, offset = 2.0 / 255.0, -1.0

    def __init__(self, n=12):
        self.images = np.random.RandomState(15).uniform(0, 255, (n, 64, 64, 3)).astype(np.float32)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return self.images[i], 0


def test_celeba_cache_reads_in_the_jax_packages_order(tmp_path):
    written = JaxCachedDataset(_FloatFaces(), tmp_path / CACHE_DIR, CELEBA_KEY, num_workers=2,
                               verbose=False)
    want = JaxDataLoader(written, 5, JaxSampler(len(written), seed=3), num_workers=2)
    got = get_dataloader("celeba", 5, 3, tmp_path)
    try:
        for _ in range(4):  # crosses an epoch boundary
            a, b = got.next_batch(), want.next_batch()
            assert np.array_equal(a["label"], b["label"])
            np.testing.assert_allclose(a["image"], b["image"], rtol=0, atol=1e-6)
            assert a["image"].shape == (5, 64, 64, 3)
    finally:
        got.close()


def test_deediff_trains_on_the_synthetic_celeba_cache(files):
    trainer = train.main(_argv(files, "celeba", 2, "--dataset", "celeba", "--config_path",
                               files["celeba_config"]))
    assert trainer.dataloader.dataset.images.shape == (24, 64, 64, 3)
    assert [log["step"] for log in trainer.logs] == [1, 2]
    assert np.isfinite(trainer.logs[-1]["train_loss"])
    assert (_checkpoint(trainer) / CHECKPOINT_FILE).exists()
