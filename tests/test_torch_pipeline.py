"""Pipeline-parallel DuoDiff (``duodiff_tpu_torch/diffusion/pipeline.py``,
``parallel/mesh.py:pipeline_grid``, ``sample.py --pipeline_parallel``) in
worlds of gloo processes on the CPU (tests/torch_dist_worker.py), at JAX's
test shapes (``tests/test_pipeline.py``: img 16, patch 4, D 32, depth 3 /
5, 4 heads, mlp_ratio 2), 20 steps with t_switch 8, 3 micro-batches:

- at 2 ranks, at 4 (two a stage) and at 3 (the third waits) the pipelined
  samples equal the one-process ``duodiff_sample`` on the same generator to
  the bit (the port's noise rule: each micro-batch's rows of the whole
  batch's draws, the generator's state handed from stage A to stage B);
- on one injected noise table they are within rtol 1e-4, atol 1e-5 of JAX's
  sequential DuoDiff composition (``ddpm_scan`` segments on
  ``noise_table``, the weights crossed over by ``utils/convert.py``), the
  bound at which JAX's ``test_pipeline_matches_sequential`` holds JAX's
  pipeline to that composition;
- t_switch == steps runs the shallow model only; t_switch 0 and steps + 1
  raise ValueError;
- the stages' ranks are disjoint and paired rank by rank;
- stage A runs ahead: with a sleep in every model call, stage A's
  micro-batch i + 1 ends before stage B's micro-batch i does;
- the CLI writes the one-process run's files (a latent guided pair's
  too), and keeps JAX's refusals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_dist_worker import REPO, run_world

from duodiff_tpu.config import UViTConfig as JaxConfig
from duodiff_tpu.diffusion import sampling as jsampling
from duodiff_tpu.diffusion.schedule import NoiseSchedule as JaxSchedule
from duodiff_tpu.models.uvit import init_uvit as jax_init_uvit
from duodiff_tpu_torch import sample
from duodiff_tpu_torch.config import UViTConfig
from duodiff_tpu_torch.diffusion.pipeline import DuoDiffPipeline
from duodiff_tpu_torch.diffusion.sampling import duodiff_sample
from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
from duodiff_tpu_torch.models.uvit import UViT
from duodiff_tpu_torch.parallel.mesh import Grid
from duodiff_tpu_torch.utils.convert import uvit_state_dict_from_jax

torch.set_num_threads(1)

TINY = dict(img_size=16, patch_size=4, in_chans=3, embed_dim=32, num_heads=4, mlp_ratio=2,
            num_classes=-1, normalize_timesteps=True)
STEPS, T_SWITCH, BATCH, MICRO, SEED = 20, 8, 6, 2, 0
IMG = (16, 16, 3)
SLEEP = 0.03
TIMEOUT = 120


@pytest.fixture(scope="module")
def models():
    """The JAX models (depth 3 and 5), their params, and the port's models on
    the same weights."""
    out = {}
    for name, depth, seed in (("shallow", 3, 0), ("full", 5, 1)):
        jmodel, params = jax_init_uvit(JaxConfig(**TINY, depth=depth), jax.random.PRNGKey(seed),
                                       dtype=jnp.float32)
        model = UViT(UViTConfig(**TINY, depth=depth), dtype=torch.float32, attn_impl="fused")
        model.load_state_dict(uvit_state_dict_from_jax(params), strict=True)
        model.eval().pack_for_kernels()
        out[name] = (jmodel, params, model)
    return out


def _table():
    rng = np.random.RandomState(3)
    return torch.from_numpy(rng.randn(STEPS, BATCH, *IMG).astype(np.float32))


def _world(models, tmp_path, n: int, jobs: list):
    """Run ``jobs`` on an n-rank pipeline world; returns (rank 0's gathered
    batches by job, every rank's record)."""
    inputs = tmp_path / "inputs.pth"
    torch.save({"shallow": models["shallow"][2].state_dict(),
                "full": models["full"][2].state_dict(),
                "shallow_config": dict(TINY, depth=3), "full_config": dict(TINY, depth=5),
                "batch": BATCH, "microbatch": MICRO, "steps": STEPS, "seed": SEED, "img": IMG,
                "jobs": jobs}, inputs)
    rcs, outs = run_world(n, [str(REPO / "tests/torch_dist_worker.py"), "pipeline", str(inputs),
                              str(tmp_path)], tmp_path, timeout=TIMEOUT)
    assert rcs == [0] * n, "\n".join(o[-3000:] for o in outs)
    samples = torch.load(tmp_path / "samples.pth")
    records = [torch.load(tmp_path / f"rank{r}.pth") for r in range(n)]
    return {k: torch.cat(v) for k, v in samples.items()}, records, outs


@pytest.fixture(scope="module")
def two_ranks(models, tmp_path_factory):
    jobs = [{"name": "generator", "t_switch": T_SWITCH},
            {"name": "table", "t_switch": T_SWITCH, "table": _table()},
            {"name": "shallow_only", "t_switch": STEPS},
            {"name": "sleep", "t_switch": T_SWITCH, "sleep": SLEEP}]
    return _world(models, tmp_path_factory.mktemp("pp2"), 2, jobs)


def _one_process(models, t_switch=T_SWITCH):
    """The one-process DuoDiff run on the run's generator."""
    with torch.no_grad():
        return duodiff_sample(models["shallow"][2], models["full"][2],
                              torch.Generator().manual_seed(SEED),
                              schedule=NoiseSchedule.create(steps=STEPS), shape=(BATCH, *IMG),
                              t_switch=t_switch)


def test_two_ranks_equal_the_one_process_run(models, two_ranks):
    samples, records, outs = two_ranks
    assert "stage A ranks 0-0, stage B ranks 1-1: 3 micro-batches of 2" in outs[0]
    assert torch.equal(samples["generator"], _one_process(models))


@pytest.mark.parametrize("n", [3, 4])
def test_more_ranks_equal_the_one_process_run(models, tmp_path, n):
    """Four ranks run each micro-batch data-parallel, a row a rank of each
    stage; of three the last waits."""
    samples, records, outs = _world(models, tmp_path, n, [{"name": "generator",
                                                          "t_switch": T_SWITCH}])
    assert torch.equal(samples["generator"], _one_process(models))
    half = n // 2
    assert [r["stage"] for r in records] == [0] * half + [1] * half + [None] * (n % 2)
    if n % 2:
        assert f"rank {n - 1} waits" in outs[0] and records[-1]["ends"]["generator"] == []


def test_the_stages_are_disjoint_and_paired(two_ranks):
    _, records, _ = two_ranks
    stages = {0: set(), 1: set()}
    for r in records:
        stages[r["stage"]].add(r["rank"])
    assert stages == {0: {0}, 1: {1}} and stages[0].isdisjoint(stages[1])
    assert [r["peer"] for r in records] == [1, 0]


def test_noise_table_matches_jax_sequential_composition(models, two_ranks):
    """ddpm_scan over the shallow model's segment, then the full model's, on
    the same table and x_T (the generator's first draw of the whole batch,
    which the pipeline's stage A makes)."""
    samples, _, _ = two_ranks
    table = _table()
    x0 = torch.randn((BATCH, *IMG), generator=torch.Generator().manual_seed(SEED))
    js = JaxSchedule.create(steps=STEPS)
    x, key = jnp.asarray(x0.numpy()), jax.random.PRNGKey(0)
    for name, ts in (("shallow", jnp.arange(STEPS - 1, STEPS - T_SWITCH - 1, -1)),
                     ("full", jnp.arange(STEPS - T_SWITCH - 1, -1, -1))):
        jmodel, params, _ = models[name]
        x, key = jsampling.ddpm_scan(
            lambda xx, t, y, m=jmodel, p=params: m.apply({"params": p}, xx, t, y), js,
            "predict_noise", x, key, ts, noise_table=jnp.asarray(table.numpy()))
    np.testing.assert_allclose(samples["table"].numpy(), np.asarray(x), rtol=1e-4, atol=1e-5)


def test_t_switch_equal_to_steps_runs_the_shallow_model_only(models, two_ranks):
    """Stage B hands x_mid back unchanged (its model raises if called)."""
    samples, _, _ = two_ranks
    assert torch.equal(samples["shallow_only"], _one_process(models, t_switch=STEPS))


@pytest.mark.parametrize("t_switch", [0, STEPS + 1])
def test_t_switch_outside_the_schedule_is_refused(t_switch):
    with pytest.raises(ValueError, match=rf"t_switch must be in \(0, {STEPS}\]"):
        DuoDiffPipeline(None, None, NoiseSchedule.create(steps=STEPS), t_switch=t_switch,
                        grid=Grid(stages=2))


def test_stage_a_runs_ahead(two_ranks):
    """Stage A's micro-batch i + 1 ends (its last model call) before stage
    B's micro-batch i does (its yield): A computed while B did."""
    _, records, _ = two_ranks
    a, b = records[0]["ends"]["sleep"], records[1]["ends"]["sleep"]
    assert len(a) == len(b) == BATCH // MICRO
    assert all(a[i + 1] < b[i] for i in range(len(a) - 1)), (a, b)


def _cli_argv(tmp_path, out, *extra, latent: bool = False):
    """The sampling CLI's argv on a tiny pair; ``latent``: a class-conditional
    latent pair (8 x 8 x 4 latents, a tiny random autoencoder) sampled with
    guidance on random classes."""
    params = dict(TINY, qkv_bias=False, mlp_time_embed=False)
    block, flags = "", []
    if latent:
        from duodiff_tpu_torch.config import AutoencoderConfig
        from duodiff_tpu_torch.models.autoencoder import init_autoencoder

        ae = init_autoencoder(AutoencoderConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1),
                              generator=torch.Generator().manual_seed(0))
        torch.save(ae.state_dict(), tmp_path / "ae.pth")
        params.update(img_size=8, patch_size=2, in_chans=4, num_classes=5)
        block = (f"autoencoder:\n  autoencoder_checkpoint_path: {tmp_path / 'ae.pth'}\n"
                 "  ch: 32\n  ch_mult: [1, 2]\n  num_res_blocks: 1\n")
        flags = ["--class_id", "-1", "--guidance_scale", "1.5"]
    cfgs = []
    for depth in (3, 5):
        path = tmp_path / f"tiny{depth}.yaml"
        path.write_text("model_params:\n" + "".join(
            f"  {k}: {v}\n" for k, v in dict(params, depth=depth).items()) + block)
        cfgs.append(str(path))
    return ["--config_path", cfgs[0], "--config_path_late", cfgs[1], "--t_switch",
            str(T_SWITCH), "--num_timesteps", str(STEPS), "--device", "cpu", "--random_init",
            "--batch_size", str(BATCH), "--parametrization", "predict_noise", "--seed", "3",
            "--output_folder", str(out), *flags, *extra]


@pytest.mark.parametrize("latent", [False, True], ids=["pixels", "latent_guided"])
def test_cli_writes_the_one_process_files(tmp_path, latent):
    """Rank 0 writes the one-process run's files; a latent pair's are decoded
    there, after the timed run, and guided labels come from the generator."""
    one = sample.main(_cli_argv(tmp_path, tmp_path / "one", latent=latent))
    rcs, outs = run_world(2, ["-m", "duodiff_tpu_torch.sample",
                              *_cli_argv(tmp_path, tmp_path / "pp", "--pipeline_parallel",
                                         "--pipeline_microbatch", str(MICRO), latent=latent)],
                          tmp_path, timeout=TIMEOUT)
    assert rcs == [0, 0], "\n".join(o[-3000:] for o in outs)
    assert "3 micro-batches of 2" in outs[0] and "Elapsed time" in outs[0]
    assert "Elapsed time" not in outs[1]
    assert ("Decode time" in outs[0]) == latent
    np.testing.assert_array_equal(np.load(tmp_path / "pp" / "samples.npy"),
                                  np.load(tmp_path / "one" / "samples.npy"))
    names = sorted(p.name for p in (tmp_path / "one").glob("*.png"))
    assert len(names) == BATCH + 1 and sorted(p.name for p in (tmp_path / "pp").glob("*.png")) == names
    assert one["samples"].shape == (BATCH, *IMG)


@pytest.mark.parametrize("drop,extra,match", [
    (["--config_path_late", "--t_switch"], [], "needs the DuoDiff pair"),
    (["--t_switch"], [], "needs the DuoDiff pair"),
    ([], ["--use_ddim"], "supports plain DDPM sampling"),
    ([], ["--use_dpm_solver"], "supports plain DDPM sampling"),
    ([], ["--timesteps_save", "5"], "supports plain DDPM sampling"),
    ([], ["--interleave_every", "2"], "--interleave_every supports plain DDPM sampling"),
    ([], ["--cache_every", "2"], "no --use_ddim/--pipeline_parallel"),
    ([], ["--pipeline_microbatch", "4"], "must be a multiple of --pipeline_microbatch 4"),
    ([], [], r"needs >= 2 ranks \(have 1\)"),
], ids=["no_pair", "no_t_switch", "ddim", "dpm", "timesteps_save", "interleave", "cache",
        "microbatch", "one_rank"])
def test_cli_refusals(tmp_path, monkeypatch, drop, extra, match):
    """JAX's refusals, in its order, before any rank joins a group; one
    process (no torchrun environment) has no second stage."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    argv = _cli_argv(tmp_path, tmp_path / "out", "--pipeline_parallel", *extra)
    for flag in drop:  # the flag and its value
        i = argv.index(flag)
        del argv[i:i + 2]
    with pytest.raises(SystemExit, match=match):
        sample.main(argv)
    assert not list(tmp_path.rglob("*.png"))
