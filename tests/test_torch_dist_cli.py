"""The port's CLIs on the process grid (duodiff_tpu_torch.parallel), as
worlds of gloo processes on the CPU (tests/torch_dist_worker.run_world: the
torchrun environment set by hand), at a tiny config on synthetic palette
data, against their one-process runs:

- ``train --model_parallel 2`` (4 ranks: data 2 x model 2) and
  data-parallel (2 ranks): the logged losses within rtol 2e-4 of the
  one-process run's (JAX's ``test_main_cli_train_tensor_parallel`` holds its
  TP and DP runs so; the JAX CLI draws its noise from JAX's generator, the
  port from torch's, so the port's runs are held to its one-process run,
  whose step tests/test_torch_train_step.py holds against JAX's);
- gradient accumulation and the non-finite check under tensor parallelism;
- ``--fsdp`` (2 ranks: data 2), alone and with ``--grad_accum 2
  --skip_nonfinite 2``: the losses within rtol 2e-4 of one process's;
- a tensor-parallel checkpoint: the full state dict under the reference's
  names, resumed by a tensor-parallel run to the same losses and by a
  one-process run within rtol 2e-4; an FSDP checkpoint, full too, resumed
  by one process and by a tensor-parallel grid, and a tensor-parallel one
  by an FSDP run;
- the data size dropping to a divisor of the batch on one node, the rank
  left over waiting;
- ``sample``: data-parallel samples equal to the one-process run's to the
  bit, ``--model_parallel 2`` within 2 pixel levels of them (JAX's
  ``test_sampler_cli_tensor_parallel``), with the fused block and with the
  unfused ``pallas`` block; ``eesample --model_parallel 2`` writes finite
  diagnostics;
- the refusals: int8 or ``plain`` with tensor parallelism,
  ``--pipeline_parallel`` with ``--model_parallel``, the dynamic-threshold route only for
  ``eesample``'s tensor parallelism, a partial torchrun environment, a grid
  that does not fit, a batch that does not divide the data shards.
"""

import json

import numpy as np
import pytest
import torch
from torch_dist_worker import run_world

from duodiff_tpu_torch import eesample, sample, train
from duodiff_tpu_torch.data.synthetic import write_palette_cifar
from duodiff_tpu_torch.training.checkpointer import CHECKPOINT_FILE
from duodiff_tpu_torch.utils.model_loading import load_model

torch.set_num_threads(1)

TINY = dict(img_size=32, patch_size=4, in_chans=3, embed_dim=32, num_heads=4, mlp_ratio=4,
            qkv_bias=True, mlp_time_embed=False, num_classes=-1, normalize_timesteps=True,
            depth=3)
TIMEOUT = 120


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    write_palette_cifar(d / "data", seed=0, per_batch=64)
    cfg = d / "tiny.yaml"
    cfg.write_text("model_params:\n" + "".join(f"  {k}: {v}\n" for k, v in TINY.items()))
    return {"root": d, "data": str(d / "data"), "logs": d / "logs", "config": str(cfg)}


def _train_argv(files, exp, n_steps, *extra):
    return ["--config_path", files["config"], "--device", "cpu", "--data_path", files["data"],
            "--log_path", str(files["logs"]), "--exp_name", exp, "--n_steps", str(n_steps),
            "--batch_size", "8", "--num_warmup_steps", "2", "--lr", "1e-3", "--seed", "0",
            *extra]


def _world(files, n, argv, expect_ok=True):
    rcs, outs = run_world(n, argv, files["root"], timeout=TIMEOUT)
    if expect_ok:
        assert rcs == [0] * n, "\n".join(o[-3000:] for o in outs)
    return rcs, outs


def _losses(files, exp):
    rows = [json.loads(line) for line in (files["logs"] / exp / "metrics.jsonl").read_text()
            .splitlines()]
    return {r["step"]: r["train_loss"] for r in rows if "train_loss" in r}


@pytest.fixture(scope="module")
def one_process(files):
    """The one-process run: 4 steps, a checkpoint at step 2."""
    trainer = train.main(_train_argv(files, "one", 4))
    return {log["step"]: log["train_loss"] for log in trainer.logs}


@pytest.mark.parametrize("grid", ["tp world 4", "dp world 2"])
def test_train_grid_losses_equal_the_one_process_run(files, one_process, grid):
    n, extra = {"tp world 4": (4, ["--model_parallel", "2"]), "dp world 2": (2, [])}[grid]
    exp = grid.replace(" ", "_")
    _, outs = _world(files, n, ["-m", "duodiff_tpu_torch.train",
                                *_train_argv(files, exp, 4, *extra)])
    data, model = (2, 2) if n == 4 else (2, 1)
    assert f"(data {data}, model {model}) grid of {n} ranks: backend gloo" in outs[0]
    got = _losses(files, exp)
    assert sorted(got) == sorted(one_process) == [1, 4]
    np.testing.assert_allclose([got[s] for s in (1, 4)], [one_process[s] for s in (1, 4)],
                               rtol=2e-4)
    # rank 0 alone writes the run's files
    assert (files["logs"] / exp / "hparams.json").exists()
    assert "step       1" in outs[0] and "step       1" not in outs[1]


def test_tp_accumulation_and_finite_check_equal_one_process(files):
    """--grad_accum 2 --skip_nonfinite 2 under --model_parallel 2: the
    window's mean, the clipping norm over the shards and the finite flag
    agreed over the ranks give the one-process run's losses."""
    extra = ("--grad_accum", "2", "--skip_nonfinite", "2")
    _world(files, 2, ["-m", "duodiff_tpu_torch.train", "--model_parallel", "2",
                      *_train_argv(files, "tp_accum", 4, *extra)])
    one = train.main(_train_argv(files, "one_accum", 4, *extra))
    got = _losses(files, "tp_accum")
    np.testing.assert_allclose([got[s] for s in (1, 4)],
                               [log["train_loss"] for log in one.logs], rtol=2e-4)


def test_tp_checkpoint_is_full_and_resumes_anywhere(files, one_process):
    """A --model_parallel 2 run's checkpoint holds the full state under the
    reference's names: the one-process load_model takes it strictly; a
    tensor-parallel run loaded from its step 2 ends where the unbroken one
    ended, and so does a one-process run, within rtol 2e-4."""
    argv = ["-m", "duodiff_tpu_torch.train", "--model_parallel", "2"]
    _world(files, 2, [*argv, *_train_argv(files, "tp2", 4, "--save_new_every_n_steps", "2")])
    unbroken = _losses(files, "tp2")
    step2 = files["logs"] / "tp2" / "cifar10_uvit_step-2"
    state = torch.load(step2 / CHECKPOINT_FILE, weights_only=True)
    assert state["model_state_dict"]["mid_block.attn.qkv.weight"].shape == (96, 32)
    assert state["optimizer"]["mu"]["mid_block.mlp.fc1.weight"].shape == (128, 32)
    load_model(files["config"], str(step2 / CHECKPOINT_FILE), device="cpu")
    _world(files, 2, [*argv, *_train_argv(files, "tp2_resumed", 4, "--load_checkpoint_path",
                                          str(step2))])
    resumed = _losses(files, "tp2_resumed")
    assert sorted(resumed) == [3, 4]
    np.testing.assert_allclose(resumed[4], unbroken[4], rtol=1e-6)
    trainer = train.main(_train_argv(files, "one_resumed", 4, "--load_checkpoint_path",
                                     str(step2)))
    np.testing.assert_allclose(trainer.logs[-1]["train_loss"], unbroken[4], rtol=2e-4)


FSDP = ("--fsdp", "--fsdp_min_size", "64")


@pytest.mark.parametrize("extra", [(), ("--grad_accum", "2", "--skip_nonfinite", "2")],
                         ids=["plain", "accum_skip"])
def test_fsdp_losses_equal_the_one_process_run(files, one_process, extra):
    """--fsdp over 2 data ranks: every large leaf, its AdamW moments cut in
    two; the losses are one process's (with accumulation and the finite
    check, the one-process run's with the same flags)."""
    exp = "fsdp_" + ("_".join(extra).replace("-", "") or "plain")
    _, outs = _world(files, 2, ["-m", "duodiff_tpu_torch.train",
                                *_train_argv(files, exp, 4, *FSDP, *extra)])
    assert "--fsdp: " in outs[0] and "cut over 2 data ranks" in outs[0]
    want = one_process if not extra else {
        log["step"]: log["train_loss"]
        for log in train.main(_train_argv(files, exp + "_one", 4, *extra)).logs}
    got = _losses(files, exp)
    np.testing.assert_allclose([got[s] for s in (1, 4)], [want[s] for s in (1, 4)], rtol=2e-4)


@pytest.mark.parametrize("case", ["deediff", "frozen", "deediff_data_parallel"])
def test_fsdp_early_exit_runs_equal_one_process(files, case):
    """--fsdp with the early-exit model (its heads and probes cut too), with
    --use_checkpoint, --async_checkpoint, the EMA and the in-training sampler
    (the chunks gathered whole for it), and with a frozen backbone (gathered,
    never reduce-scattered); and the early-exit model data-parallel without
    FSDP (its L_u_t, a sum over the batch, is the global batch's): the losses
    are one process's."""
    extra = {"deediff": ["--model", "deediff_uvit", "--use_checkpoint", "--async_checkpoint",
                         "--ema_decay", "0.9", "--log_every_n_steps", "4", "--n_samples", "2",
                         "--num_timesteps", "10"],
             "frozen": ["--model", "deediff_uvit", "--freeze_backbone"],
             "deediff_data_parallel": ["--model", "deediff_uvit"]}[case]
    exp = f"fsdp_{case}"
    fsdp = () if case == "deediff_data_parallel" else FSDP
    _world(files, 2, ["-m", "duodiff_tpu_torch.train", *_train_argv(files, exp, 4, *fsdp, *extra)])
    one = train.main(_train_argv(files, exp + "_one", 4, *extra))
    got = _losses(files, exp)
    np.testing.assert_allclose([got[s] for s in (1, 4)], [log["train_loss"] for log in one.logs],
                               rtol=2e-4)
    if case == "deediff":  # the sampler's outputs, and the checkpoint's full EMA
        ckpt = files["logs"] / exp / "cifar10_deediff_uvit_last" / CHECKPOINT_FILE
        state = torch.load(ckpt, weights_only=True)
        assert state["ema_state_dict"]["uvit.mid_block.attn.qkv.weight"].shape == (96, 32)
        np.testing.assert_allclose(np.load(files["logs"] / exp / "sample_stats_step4.npy"),
                                   np.load(one.log_path / "sample_stats_step4.npy"), rtol=2e-3,
                                   atol=1e-4)


def test_fsdp_checkpoint_is_full_and_resumes_across_grids(files, one_process):
    """An --fsdp run's checkpoint holds the full state (the model, AdamW's
    moments) under the reference's names: one process and a
    --model_parallel 2 grid resume it to the unbroken run's last loss; an
    --fsdp run resumes a tensor-parallel checkpoint the same way."""
    _world(files, 2, ["-m", "duodiff_tpu_torch.train",
                      *_train_argv(files, "fsdp2", 4, *FSDP, "--save_new_every_n_steps", "2")])
    unbroken = _losses(files, "fsdp2")
    step2 = files["logs"] / "fsdp2" / "cifar10_uvit_step-2"
    state = torch.load(step2 / CHECKPOINT_FILE, weights_only=True)
    assert state["model_state_dict"]["mid_block.attn.qkv.weight"].shape == (96, 32)
    assert state["optimizer"]["nu"]["mid_block.mlp.fc2.weight"].shape == (32, 128)
    load_model(files["config"], str(step2 / CHECKPOINT_FILE), device="cpu")
    one = train.main(_train_argv(files, "fsdp2_one", 4, "--load_checkpoint_path", str(step2)))
    np.testing.assert_allclose(one.logs[-1]["train_loss"], unbroken[4], rtol=2e-4)
    _world(files, 2, ["-m", "duodiff_tpu_torch.train", "--model_parallel", "2",
                      *_train_argv(files, "fsdp2_tp", 4, "--load_checkpoint_path", str(step2))])
    np.testing.assert_allclose(_losses(files, "fsdp2_tp")[4], unbroken[4], rtol=2e-4)
    # the other way round: a tensor-parallel run's checkpoint in an FSDP run
    _world(files, 2, ["-m", "duodiff_tpu_torch.train", "--model_parallel", "2",
                      *_train_argv(files, "tp_for_fsdp", 4, "--save_new_every_n_steps", "2")])
    tp_step2 = files["logs"] / "tp_for_fsdp" / "cifar10_uvit_step-2"
    _world(files, 2, ["-m", "duodiff_tpu_torch.train",
                      *_train_argv(files, "fsdp_from_tp", 4, *FSDP, "--load_checkpoint_path",
                                   str(tp_step2))])
    np.testing.assert_allclose(_losses(files, "fsdp_from_tp")[4],
                               _losses(files, "tp_for_fsdp")[4], rtol=2e-4)


def test_train_data_size_drops_to_a_divisor_of_the_batch(files):
    """Batch 6 over 4 ranks of one node: 3 data ranks of 2 rows, the fourth
    waits; the loss is the one-process run's."""
    _, outs = _world(files, 4, ["-m", "duodiff_tpu_torch.train",
                                *_train_argv(files, "drop", 2, "--batch_size", "6")])
    assert "using 3-way data parallelism" in outs[0]
    assert "no rows of the batch for this rank" in outs[3]
    one = train.main(_train_argv(files, "drop_one", 2, "--batch_size", "6"))
    got = _losses(files, "drop")
    np.testing.assert_allclose([got[1], got[2]], [log["train_loss"] for log in one.logs],
                               rtol=2e-4)


def _sample_argv(files, out, *extra):
    return ["--config_path", files["config"], "--device", "cpu", "--random_init", "--batch_size",
            "4", "--parametrization", "predict_noise", "--num_timesteps", "8", "--seed", "0",
            "--output_folder", str(out), *extra]


def test_sample_grids_against_one_process(files, tmp_path):
    one = sample.main(_sample_argv(files, tmp_path / "one"))
    _world(files, 2, ["-m", "duodiff_tpu_torch.sample", *_sample_argv(files, tmp_path / "dp")])
    _world(files, 2, ["-m", "duodiff_tpu_torch.sample",
                      *_sample_argv(files, tmp_path / "tp", "--model_parallel", "2")])
    pixels = {k: np.load(tmp_path / k / "samples.npy").astype(np.int32)
              for k in ("one", "dp", "tp")}
    assert pixels["one"].shape == (4, 32, 32, 3)
    np.testing.assert_array_equal(pixels["dp"], pixels["one"])
    assert np.max(np.abs(pixels["tp"] - pixels["dp"])) <= 2
    assert sorted(p.name for p in (tmp_path / "dp").glob("*.png")) == sorted(
        p.name for p in (tmp_path / "one").glob("*.png"))
    assert one["samples"].shape == (4, 32, 32, 3)


def test_sample_unfused_tensor_parallel_against_one_process(files, tmp_path):
    """--attn_impl pallas --model_parallel 2: the unfused block around the
    attention kernels on each rank's 2 of the 4 heads (their plain versions
    on the CPU), within 2 pixel levels of the one-process run's."""
    extra = ("--attn_impl", "pallas")
    sample.main(_sample_argv(files, tmp_path / "one", *extra))
    _world(files, 2, ["-m", "duodiff_tpu_torch.sample",
                      *_sample_argv(files, tmp_path / "tp", *extra, "--model_parallel", "2")])
    one, tp = (np.load(tmp_path / k / "samples.npy").astype(np.int32) for k in ("one", "tp"))
    assert tp.shape == (4, 32, 32, 3)
    assert np.max(np.abs(tp - one)) <= 2


def test_eesample_tensor_parallel(files, tmp_path):
    out = tmp_path / "ee"
    _world(files, 2, ["-m", "duodiff_tpu_torch.eesample", "--config_path", files["config"],
                      "--device", "cpu", "--random_init", "--batch_size", "4", "--threshold",
                      "0.5", "--num_timesteps", "8", "--seed", "0", "--output_folder", str(out),
                      "--model_parallel", "2"])
    assert (out / "0.png").exists()
    err = np.load(out / "error_prediction_by_timestep.npy")
    idx = np.load(out / "indices_by_timestep.npy")
    assert err.shape == (8, 3) and np.all(np.isfinite(err)) and idx.shape == (8, 4)


TORCHRUN_ENV = {"RANK": "0", "WORLD_SIZE": "4", "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "4",
                "MASTER_ADDR": "localhost", "MASTER_PORT": "1"}


@pytest.mark.parametrize("case", [
    "sample_int8_tp", "sample_unfused_tp", "sample_plain_tp", "train_plain_tp", "sample_pipeline", "eesample_int8_tp",
    "eesample_adaptive_tp", "eesample_static_tp", "partial_env", "no_rendezvous",
    "grid_does_not_fit", "nodes_without_multihost", "sample_batch_indivisible",
    "train_multihost_batch_indivisible",
])
def test_refusals(files, tmp_path, monkeypatch, case):
    """Each refusal names what is missing; the grid's own refuse before any
    rank joins a process group (the environment below meets nowhere)."""
    out = tmp_path / "out"
    ee = ["--config_path", files["config"], "--device", "cpu", "--random_init", "--batch_size",
          "4", "--threshold", "0.5", "--num_timesteps", "8", "--output_folder", str(out)]
    env = {}
    run, message = {
        "sample_int8_tp": (lambda: sample.main(_sample_argv(
            files, out, "--attn_impl", "fused_int8", "--model_parallel", "2")),
            "fused_int8 does not combine with --model_parallel"),
        # the unfused block now has a tensor-parallel form: what stops this run
        # is the grid's own refusal of --model_parallel 2 on one process
        "sample_unfused_tp": (lambda: sample.main(_sample_argv(
            files, out, "--attn_impl", "xla", "--model_parallel", "2")),
            "--model_parallel 2 does not divide 1 process"),
        "sample_plain_tp": (lambda: sample.main(_sample_argv(
            files, out, "--attn_impl", "plain", "--model_parallel", "2")),
            "only fused, pallas and xla have a tensor-parallel form"),
        "train_plain_tp": (lambda: train.main(_train_argv(files, "x", 2, "--attn_impl", "plain",
                                                          "--model_parallel", "2")),
                           "only fused, pallas and xla have a tensor-parallel form"),
        "sample_pipeline": (lambda: sample.main(_sample_argv(
            files, out, "--config_path_late", files["config"], "--t_switch", "4",
            "--pipeline_parallel", "--model_parallel", "2")),
            "--pipeline_parallel does not combine with --model_parallel"),
        "eesample_int8_tp": (lambda: eesample.main([*ee, "--attn_impl", "fused_int8",
                                                    "--model_parallel", "2"]),
                             "fused_int8 does not combine with --model_parallel"),
        "eesample_adaptive_tp": (lambda: eesample.main([*ee, "--adaptive_layers", "1,3",
                                                        "--model_parallel", "2"]),
                                 "does not combine with --adaptive_layers"),
        "eesample_static_tp": (lambda: eesample.main([*ee[:-6], "--static_schedule", "7-0:3",
                                                      "--num_timesteps", "8", "--output_folder",
                                                      str(out), "--model_parallel", "2"]),
                               "does not combine with --static_schedule"),
        "partial_env": (lambda: train.main(_train_argv(files, "x", 2)),
                        "LOCAL_RANK and LOCAL_WORLD_SIZE missing"),
        "no_rendezvous": (lambda: train.main(_train_argv(files, "x", 2)),
                          "lacks MASTER_ADDR / MASTER_PORT"),
        "grid_does_not_fit": (lambda: train.main(_train_argv(files, "x", 2, "--model_parallel",
                                                             "3")),
                              "--model_parallel 3 does not divide 4 ranks"),
        "nodes_without_multihost": (lambda: train.main(_train_argv(files, "x", 2)),
                                    "pass --multihost"),
        "sample_batch_indivisible": (lambda: sample.main(_sample_argv(
            files, out, "--model_parallel", "2", "--batch_size", "3")),
            "batch_size 3 must be divisible by the 2 data shards"),
        "train_multihost_batch_indivisible": (lambda: train.main(_train_argv(
            files, "x", 2, "--multihost", "--batch_size", "6")),
            "batch_size 6 must be divisible by the 4 data shards"),
    }[case]
    if case in ("partial_env",):
        env = {"RANK": "0", "WORLD_SIZE": "4"}
    elif case == "no_rendezvous":
        env = {k: v for k, v in TORCHRUN_ENV.items() if not k.startswith("MASTER")}
    elif case == "nodes_without_multihost":
        env = dict(TORCHRUN_ENV, LOCAL_WORLD_SIZE="2")
    elif case in ("grid_does_not_fit", "sample_batch_indivisible",
                  "train_multihost_batch_indivisible"):
        env = dict(TORCHRUN_ENV, LOCAL_WORLD_SIZE="2") if "multihost" in case else TORCHRUN_ENV
    for k in (*TORCHRUN_ENV, "DUODIFF_INIT_METHOD"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    # the trainer refuses a flag it cannot run with ValueError, as refuse_unported does
    with pytest.raises(ValueError if case == "train_plain_tp" else SystemExit, match=message):
        run()
    assert not out.exists() or not list(out.rglob("*.png"))
