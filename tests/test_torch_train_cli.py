"""The training CLI (``python -m duodiff_tpu_torch.train``, run in-process
on the CPU at a tiny config on synthetic palette data): end to end with a
falling loss, a resumed run equal to an unbroken one bit for bit, the
checkpoint in the sampling CLI, distillation, SIGTERM checkpoint-and-exit,
corrupt-checkpoint skipping, and the refusal of every flag whose machinery
is not ported."""

import json
import signal

import numpy as np
import pytest
import torch

from duodiff_tpu_torch import sample, train
from duodiff_tpu_torch.data.synthetic import write_palette_cifar
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
    "label_dropout": ["--label_dropout", "0.1"],
    "log_every_n_steps": ["--log_every_n_steps", "5"],
    "grad_accum": ["--grad_accum", "2"],
    "skip_nonfinite": ["--skip_nonfinite", "3"],
    "use_checkpoint": ["--use_checkpoint"],
    "async_checkpoint": ["--async_checkpoint"],
    "profile": ["--profile"],
    "fsdp": ["--fsdp"],
    "model_parallel": ["--model_parallel", "2"],
    "multihost": ["--multihost"],
    "attn_impl_xla": ["--attn_impl", "xla"],
    "attn_impl_pallas": ["--attn_impl", "pallas"],
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_unported_flags_are_refused(files, name):
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
