"""The training CLI (``python -m duodiff_tpu_torch.train``, run in-process
on the CPU at a tiny config on synthetic palette data): end to end with a
falling loss, a resumed run equal to an unbroken one bit for bit, the
checkpoint in the sampling CLI, distillation, SIGTERM checkpoint-and-exit,
corrupt-checkpoint skipping, the refusal of every flag whose machinery
is not ported (and a run with each of the three that since are), and class-conditional training on a synthetic ImageNet-64
cache with the unfused block and label dropout."""

import json
import signal

import numpy as np
import pytest
import torch

from duodiff_tpu_torch import sample, train
from duodiff_tpu_torch.data.synthetic import write_palette_cifar, write_palette_imagenet64_cache
from duodiff_tpu_torch.training.checkpointer import CHECKPOINT_FILE, Checkpointer
from duodiff_tpu_torch.utils.model_loading import load_model

torch.set_num_threads(1)

TINY = dict(img_size=32, patch_size=4, in_chans=3, embed_dim=32, num_heads=4, mlp_ratio=4,
            qkv_bias=False, mlp_time_embed=False, num_classes=-1, normalize_timesteps=True)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("train")
    write_palette_cifar(d / "data", seed=0, per_batch=64)
    out = {"data": str(d / "data"), "logs": str(d / "logs")}
    for depth in (3, 5):
        path = d / f"tiny{depth}.yaml"
        path.write_text("model_params:\n" + "".join(
            f"  {k}: {v}\n" for k, v in dict(TINY, depth=depth).items()))
        out[f"config{depth}"] = str(path)
    return out


def _argv(files, exp, n_steps, *extra):
    return ["--config_path", files["config3"], "--device", "cpu", "--data_path", files["data"],
            "--log_path", files["logs"], "--exp_name", exp, "--n_steps", str(n_steps),
            "--batch_size", "8", "--num_warmup_steps", "3", "--lr", "1e-3", "--seed", "0",
            *extra]


def test_cli_trains_and_the_loss_falls(files):
    trainer = train.main(_argv(files, "falls", 60, "--batch_size", "16"))
    losses = [log["train_loss"] for log in trainer.logs]
    assert [log["step"] for log in trainer.logs] == [1, 50, 60]
    assert np.isfinite(losses).all() and losses[-1] < 0.9 * losses[0]
    run = trainer.log_path
    metrics = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert [m["step"] for m in metrics] == [1, 50, 60]
    assert json.loads((run / "hparams.json").read_text())["n_steps"] == 60
    ckpt = run / "cifar10_uvit_last"
    assert (ckpt / CHECKPOINT_FILE).exists() and (ckpt / "run_args.json").exists()
    assert Checkpointer.restore(ckpt)["step"] == 60


def _final_state(trainer):
    return (trainer.model.state_dict(), trainer.state.optimizer.state_dict(), trainer.state.ema,
            trainer.dataloader.get_state())


def test_resumed_run_equals_an_unbroken_one(files):
    extra = ("--ema_decay", "0.9", "--save_every_n_steps", "2")
    whole = _final_state(train.main(_argv(files, "whole", 8, *extra)))
    first = train.main(_argv(files, "halves", 4, *extra))
    assert first.logs[-1]["step"] == 4
    second = train.main(_argv(files, "halves", 8, "--resume", *extra))
    assert second.start_step == 4 and [log["step"] for log in second.logs] == [5, 8]
    halves = _final_state(second)
    for a, b in zip(whole[0].values(), halves[0].values()):
        assert torch.equal(a, b)
    assert whole[1]["count"] == halves[1]["count"] == 8
    for key in ("mu", "nu"):
        for name in whole[1][key]:
            assert torch.equal(whole[1][key][name], halves[1][key][name])
    for name in whole[2]:
        assert torch.equal(whole[2][name], halves[2][name])
    np.testing.assert_array_equal(whole[3]["perm"], halves[3]["perm"])
    assert whole[3]["perm_index"] == halves[3]["perm_index"]


def test_checkpoint_loads_into_the_sampling_cli(files, tmp_path):
    trainer = train.main(_argv(files, "to_sample", 3))
    path = trainer.log_path / "cifar10_uvit_last" / CHECKPOINT_FILE
    model, _ = load_model(files["config3"], str(path), device="cpu", dtype=torch.float32)
    model.pack_for_kernels()
    trainer.model.pack_for_kernels()
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    t = torch.tensor([10.0, 900.0])
    with torch.no_grad():
        assert torch.equal(model.eval()(x, t), trainer.model.eval()(x, t))
    out = sample.main(["--device", "cpu", "--config_path", files["config3"],
                       "--checkpoint_path", str(path), "--num_timesteps", "4",
                       "--batch_size", "2", "--parametrization", "predict_noise",
                       "--output_folder", str(tmp_path)])
    assert out["samples"].shape == (2, 32, 32, 3) and np.isfinite(out["samples"]).all()


def test_distillation_run(files):
    trainer = train.main(_argv(files, "distill", 2, "--distill_config", files["config5"],
                               "--distill_alpha", "0.5"))
    assert len(trainer.teacher.blocks()) == 5 and not trainer.teacher.training
    assert {"distill_loss", "task_loss", "grad_norm"} <= set(trainer.logs[-1])


def test_sigterm_checkpoints_and_exits(files):
    args = train.get_args(_argv(files, "preempt", 10))
    train.merge_args_with_config(args, args.config_path)
    from duodiff_tpu_torch.training.trainer import Trainer

    trainer = Trainer(args)
    step_fn = trainer._train_step

    def preempted_at_2(state, batch, step):
        if step == 2:
            signal.raise_signal(signal.SIGTERM)
        return step_fn(state, batch, step)

    trainer._train_step = preempted_at_2
    trainer.train()
    assert trainer.logs[-1]["step"] == 1
    assert Checkpointer.restore(trainer.log_path / "cifar10_uvit_last")["step"] == 2


def test_last_checkpoint_skips_corrupt_ones(tmp_path):
    ckpt = Checkpointer(tmp_path, "run", dataset="cifar10", model="uvit")
    state = {"w": torch.ones(2)}
    ckpt.save(step=3, model_state=state, new_checkpoint=True)
    last = ckpt.save(step=5, model_state=state)
    assert ckpt.last_checkpoint() == last
    (last / CHECKPOINT_FILE).write_bytes(b"truncated")
    assert ckpt.last_checkpoint().name == "cifar10_uvit_step-3"


REFUSED = {
    "deediff": ["--model", "deediff_uvit"],
    "load_backbone": ["--load_backbone", "x.pth"],
    "freeze_backbone": ["--freeze_backbone"],
    "log_every_n_steps": ["--log_every_n_steps", "5"],
    "async_checkpoint": ["--async_checkpoint"],
    "profile": ["--profile"],
    "fsdp": ["--fsdp"],
    "model_parallel": ["--model_parallel", "2"],
    "multihost": ["--multihost"],
}


# refused until their machinery was ported; the cases keep their names and
# now hold that a run with the flag trains
PORTED = {
    "grad_accum": ["--grad_accum", "2"],
    "skip_nonfinite": ["--skip_nonfinite", "3"],
    "use_checkpoint": ["--use_checkpoint"],
}


@pytest.mark.parametrize("name", sorted({**REFUSED, **PORTED}))
def test_unported_flags_are_refused(files, name):
    if name in PORTED:
        trainer = train.main(_argv(files, f"ported_{name}", 2, *PORTED[name]))
        assert trainer.logs[-1]["step"] == 2 and np.isfinite(trainer.logs[-1]["train_loss"])
        return
    flag = REFUSED[name][0]
    with pytest.raises(ValueError, match=f"{flag} .*not ported yet"):
        train.main(_argv(files, "refused", 2, *REFUSED[name]))


def test_autoencoder_config_and_fp32_fused_are_refused(files, tmp_path):
    latent = tmp_path / "latent.yaml"
    latent.write_text(open(files["config3"]).read() + "autoencoder:\n  ch: 128\n")
    with pytest.raises(NotImplementedError, match="autoencoder"):
        train.main(_argv(files, "refused", 2) + ["--config_path", str(latent)])
    with pytest.raises(ValueError, match="--use_amp"):
        train.main(_argv(files, "refused", 2, "--attn_impl", "fused"))


def test_label_dropout_is_refused_without_a_class_conditional_model(files):
    with pytest.raises(ValueError, match="--label_dropout needs a class-conditional model"):
        train.main(_argv(files, "refused", 2, "--label_dropout", "0.1"))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_unfused_block_trains_like_the_plain_one(files, impl):
    """--attn_impl xla and pallas run the unfused block; in fp32 on the CPU
    their three steps follow the plain sublayers' to summation order."""
    want = train.main(_argv(files, "plain3", 3, "--attn_impl", "plain")).logs[-1]
    got = train.main(_argv(files, impl, 3, "--attn_impl", impl)).logs[-1]
    assert got["step"] == 3
    np.testing.assert_allclose(got["train_loss"], want["train_loss"], rtol=1e-4)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-3)


@pytest.fixture(scope="module")
def imagenet(tmp_path_factory):
    d = tmp_path_factory.mktemp("imagenet")
    write_palette_imagenet64_cache(d / "data", n=48, seed=0, num_classes=7)  # labels 0..6
    out = {"data": str(d / "data"), "logs": str(d / "logs")}
    for name, classes in (("reserved", 8), ("aliased", 7)):
        path = d / f"{name}.yaml"
        path.write_text("model_params:\n" + "".join(f"  {k}: {v}\n" for k, v in dict(
            TINY, img_size=64, patch_size=16, embed_dim=128, num_heads=2, depth=3,
            num_classes=classes, normalize_timesteps=False).items()))
        out[name] = str(path)
    return out


def _imagenet_argv(imagenet, config, exp, *extra):
    return ["--config_path", imagenet[config], "--dataset", "imagenet64", "--device", "cpu",
            "--data_path", imagenet["data"], "--log_path", imagenet["logs"], "--exp_name", exp,
            "--n_steps", "4", "--batch_size", "8", "--num_warmup_steps", "2", "--seed", "0",
            *extra]


@pytest.mark.parametrize("use_amp", [False, True], ids=["fp32", "bf16"])
def test_imagenet64_cache_trains_with_pallas_and_label_dropout(imagenet, use_amp):
    extra = ["--attn_impl", "pallas", "--label_dropout", "0.25"] + (["--use_amp"] * use_amp)
    trainer = train.main(_imagenet_argv(imagenet, "reserved", f"cfg{use_amp}", *extra))
    assert trainer.has_labels and trainer.model.label_emb.num_embeddings == 8
    assert [log["step"] for log in trainer.logs] == [1, 4]
    assert all(np.isfinite(log["train_loss"]) and np.isfinite(log["grad_norm"])
               for log in trainer.logs)
    ckpt = trainer.log_path / "imagenet64_uvit_last"
    model, cfg = load_model(imagenet["reserved"], str(ckpt / CHECKPOINT_FILE), device="cpu",
                            attn_impl="pallas")
    assert cfg.num_classes == 8
    for (name, a), b in zip(model.state_dict().items(), trainer.model.state_dict().values()):
        assert torch.equal(a, b), name


def test_label_dropout_is_refused_when_the_null_label_aliases_a_class(imagenet):
    with pytest.raises(ValueError, match="alias the null token"):
        train.main(_imagenet_argv(imagenet, "aliased", "aliased", "--label_dropout", "0.1"))


def test_imagenet64_without_a_cache_is_refused(files):
    with pytest.raises(NotImplementedError, match="image decoding"):
        train.main(_argv(files, "nocache", 2, "--dataset", "imagenet64"))
