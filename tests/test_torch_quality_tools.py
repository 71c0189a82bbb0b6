"""The port's quality tools (``duodiff_tpu_torch/tools``: convergence_probe,
quality_matrix, score_quality, t_switch_sweep, trajectory_parity,
probe_cache_gamma) and its ``fid`` CLI, against the JAX package's tools
where they compute the same thing, at tiny sizes on the CPU.

- The probe's data files are byte-equal to the JAX tool's for a seed; its
  ImageNet-64 caches hold the pixels, in the order, of the JAX tool's PNG
  folders. ``measure`` and ``draw_reference`` equal JAX's.
- ``make_switch_sampler`` on crossed-over weights against JAX's, both driven
  by one injected noise table: 1e-4, the trajectory bound of the port's
  sampler tests.
- The CLIs run end to end (``--device cpu``, 20 steps): quality_matrix's
  rows, provenance, merge and refusals; score_quality's merge and ranking
  (on a cheap stand-in feature map: the Frechet code itself is held in
  ``test_torch_eval_metrics.py``); trajectory_parity's row names and kinds
  (JAX's, less its rbg-vs-threefry RNG row; torch has one generator
  family); probe_cache_gamma's candidates against JAX's derivation; the fid
  CLI's ``--save_real_stats`` and ``--real_stats``.
"""

import dataclasses
import json
import pickle
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))

import convergence_probe as jax_probe  # noqa: E402
import score_quality as jax_score  # noqa: E402
import t_switch_sweep as jax_sweep  # noqa: E402

from duodiff_tpu.config import UViTConfig as JaxConfig  # noqa: E402
from duodiff_tpu.diffusion import sampling as jsampling  # noqa: E402
from duodiff_tpu.diffusion.cache_schedule import derive_anchor_table as jax_derive  # noqa: E402
from duodiff_tpu.diffusion.cache_schedule import uniform_budget as jax_budget  # noqa: E402
from duodiff_tpu.diffusion.schedule import NoiseSchedule as JaxSchedule  # noqa: E402
from duodiff_tpu.models.uvit import init_uvit as jax_init_uvit  # noqa: E402
from duodiff_tpu_torch import fid as fid_cli  # noqa: E402
from duodiff_tpu_torch import sample  # noqa: E402
from duodiff_tpu_torch.config import UViTConfig  # noqa: E402
from duodiff_tpu_torch.data.synthetic import write_palette_cifar  # noqa: E402
from duodiff_tpu_torch.diffusion import sampling  # noqa: E402
from duodiff_tpu_torch.diffusion.cache_schedule import save_cache_schedule  # noqa: E402
from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule  # noqa: E402
from duodiff_tpu_torch.evaluation import fid as port_fid  # noqa: E402
from duodiff_tpu_torch.models.uvit import UViT  # noqa: E402
from duodiff_tpu_torch.tools import (  # noqa: E402
    convergence_probe,
    probe_cache_gamma,
    quality_matrix,
    score_quality,
    t_switch_sweep,
    trajectory_parity,
)
from duodiff_tpu_torch.utils.convert import uvit_state_dict_from_jax  # noqa: E402

torch.set_num_threads(1)

TINY = """model_params:
  img_size: 16
  patch_size: 4
  in_chans: 3
  embed_dim: 32
  depth: {depth}
  num_heads: 2
  mlp_ratio: 4
  qkv_bias: False
  mlp_time_embed: False
  num_classes: -1
  normalize_timesteps: True
{extra}"""


def _files(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_textured_and_palette_files_equal_jax(tmp_path):
    convergence_probe.write_textured_cifar(tmp_path / "port_t", seed=3, per_batch=16)
    jax_probe.write_textured_cifar(tmp_path / "jax_t", seed=3, per_batch=16)
    assert _files(tmp_path / "port_t") == _files(tmp_path / "jax_t") != {}
    write_palette_cifar(tmp_path / "port_p", convergence_probe.PALETTES[8], seed=3, per_batch=16)
    jax_probe.write_palette_cifar(tmp_path / "jax_p", jax_probe.PALETTES[8], seed=3,
                                  per_batch=16)
    assert _files(tmp_path / "port_p") == _files(tmp_path / "jax_p") != {}
    with open(tmp_path / "port_t" / "cifar10" / "cifar-10-batches-py" / "data_batch_2",
              "rb") as f:
        assert pickle.load(f)[b"data"].shape == (16, 3072)


@pytest.mark.parametrize("distribution", ["palette", "textured"])
def test_imagenet64_caches_hold_the_jax_folders_pixels(distribution, tmp_path):
    if distribution == "palette":
        cache = convergence_probe.write_palette_imagenet64(
            tmp_path / "port", convergence_probe.PALETTES[4], seed=1, per_class=3, size=16)
        jax_probe.write_palette_imagefolder(tmp_path / "jax", jax_probe.PALETTES[4], seed=1,
                                            per_class=3, size=16)
    else:
        cache = convergence_probe.write_textured_imagenet64(tmp_path / "port", seed=1,
                                                            per_class=3, size=16)
        jax_probe.write_textured_imagefolder(tmp_path / "jax", seed=1, per_class=3, size=16)
    pngs = sorted((tmp_path / "jax" / "imagenet").rglob("*.png"))
    want = np.stack([np.asarray(Image.open(p).convert("RGB"), np.float32) for p in pngs])
    np.testing.assert_array_equal(np.load(cache / "images.npy"), want)
    np.testing.assert_array_equal(np.load(cache / "labels.npy"),
                                  [int(p.parent.name[1:]) for p in pngs])


def test_measure_and_draw_reference_equal_jax(tmp_path):
    for distribution, k in (("palette", 4), ("textured", 4), ("palette", 1)):
        got = score_quality.draw_reference(distribution, k, 12, 32, seed=5)
        np.testing.assert_array_equal(got, jax_score.draw_reference(distribution, k, 12, 32, 5))
    imgs = (score_quality.draw_reference("palette", 4, 6, 16, seed=2) * 255).astype(np.uint8)
    for i, im in enumerate(imgs):
        Image.fromarray(im).save(tmp_path / f"{i}.png")
    Image.fromarray(imgs[0]).save(tmp_path / "grid_image.png")
    for palette in (convergence_probe.PALETTES[4], convergence_probe.TEXTURE_PALETTE):
        assert convergence_probe.measure(tmp_path, palette) == jax_probe.measure(tmp_path, palette)


def _port_schedule_from(js: JaxSchedule) -> NoiseSchedule:
    return NoiseSchedule(*(torch.from_numpy(np.array(getattr(js, f.name)))
                           for f in dataclasses.fields(NoiseSchedule)))


@pytest.mark.parametrize("t_switch", [0, 4, 10])
def test_switch_sampler_matches_jax(t_switch):
    steps, shape = 10, (2, 16, 16, 3)
    models = []
    for depth, seed in ((3, 0), (5, 1)):
        kw = dict(img_size=16, patch_size=4, in_chans=3, embed_dim=32, depth=depth,
                  num_heads=2, mlp_ratio=4, num_classes=-1, normalize_timesteps=True)
        jmodel, params = jax_init_uvit(JaxConfig(**kw), jax.random.PRNGKey(seed),
                                       dtype=jnp.float32, attn_impl="fused")
        port = UViT(UViTConfig(**kw), dtype=torch.float32)
        port.load_state_dict(uvit_state_dict_from_jax(params), strict=True)
        port.eval().pack_for_kernels()
        models.append((lambda x, t, y, m=jmodel, p=params: m.apply({"params": p}, x, t, y),
                       port))
    rng = np.random.RandomState(7)
    x0 = rng.randn(*shape).astype(np.float32)
    table = rng.randn(steps, *shape).astype(np.float32)
    js = JaxSchedule.create(steps=steps)

    class JaxTableSampler:
        def __init__(self, apply):
            self.apply = apply

        def init(self, key, _shape):
            return jnp.asarray(x0), key

        def run(self, x, key, t_start, t_end, y):
            return jsampling.ddpm_scan(self.apply, js, "predict_noise", x, key,
                                       jnp.arange(t_start, t_end - 1, -1), y,
                                       noise_table=jnp.asarray(table))

    class PortTableSampler(sampling.DDPMSampler):
        def init(self, generator, _shape):
            return torch.from_numpy(x0)

    want = jax_sweep.make_switch_sampler(JaxTableSampler(models[0][0]),
                                         JaxTableSampler(models[1][0]), js, shape)(
        jax.random.PRNGKey(0), t_switch)
    ps = _port_schedule_from(js)
    samplers = [PortTableSampler(m, ps, noise_table=torch.from_numpy(table)) for _, m in models]
    with torch.no_grad():
        got = t_switch_sweep.make_switch_sampler(*samplers, ps, shape)(None, t_switch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def probe_run(tmp_path_factory):
    """The convergence probe end to end on its built-in tiny model: 4 steps,
    20-step sampling, on the CPU."""
    work = tmp_path_factory.mktemp("probe")
    return convergence_probe.main([
        "--steps", "4", "--batch", "4", "--num_timesteps", "20", "--sample_batch", "2",
        "--warmup", "1", "--workdir", str(work), "--device", "cpu"])


def test_convergence_probe_runs_the_port_clis(probe_run):
    assert probe_run["n_samples"] == 2 and probe_run["steps"] == 4
    assert np.isfinite(probe_run["train_loss_first"]) and np.isfinite(probe_run["train_loss_last"])
    assert Path(probe_run["checkpoint"]).exists()
    assert sum(probe_run["mode_counts"]) == 2


def test_quality_matrix_rows_provenance_and_merge(probe_run, tmp_path):
    out = tmp_path / "qm"
    out.mkdir()
    prior = {"prior_row": {"within_image_std": 0.5, "elapsed_s": 1.0}}
    (out / "quality_matrix.json").write_text(json.dumps(prior))
    rows = quality_matrix.main([
        "--config", probe_run["config"], "--checkpoint", probe_run["checkpoint"],
        "--methods", "ddpm,int8,cache3,ddim50,dpm20", "--num_timesteps", "20", "--batch", "2",
        "--seed", "3", "--out", str(out), "--device", "cpu"])
    assert rows["prior_row"] == prior["prior_row"]
    for name in ("ddpm", "int8", "cache3", "ddim50", "dpm20"):
        r = rows[name]
        assert (r["batch"], r["num_timesteps"], r["seed"], r["n_samples"]) == (2, 20, 3, 2)
        assert r["launches"] == {}  # plain versions on the CPU: no kernel launched
        assert len(list((out / name).glob("[0-9].png"))) == 2
    on_disk = json.loads((out / "quality_matrix.json").read_text())
    assert set(on_disk) == {"prior_row", "ddpm", "int8", "cache3", "ddim50", "dpm20"}


def test_quality_matrix_keeps_a_refused_row(probe_run, tmp_path, monkeypatch):
    def refuse(argv):
        raise SystemExit("--cache_every does not combine with that")

    monkeypatch.setattr(sample, "main", refuse)
    rows = quality_matrix.main([
        "--config", probe_run["config"], "--checkpoint", probe_run["checkpoint"],
        "--methods", "cache3", "--num_timesteps", "20", "--batch", "2", "--out",
        str(tmp_path), "--device", "cpu"])
    assert rows["cache3"] == {"refused": "--cache_every does not combine with that"}


def _cheap_features(model, images01, batch_size=64):
    """A 12-d stand-in for the pool3 features: each quadrant's channel mean
    and the image's channel std and gradient energy, float32."""
    x = np.asarray(images01, np.float64)
    h = x.shape[1] // 2
    quads = [x[:, i:i + h, j:j + h].mean(axis=(1, 2)) for i in (0, h) for j in (0, h)]
    grad = np.abs(np.diff(x, axis=1)).mean(axis=(1, 2, 3))[:, None]
    feats = np.concatenate(quads[:2] + [x.std(axis=(1, 2)), grad], axis=1)
    return (feats + 1e-3 * np.random.RandomState(len(x)).randn(*feats.shape)).astype(np.float32)


def test_score_quality_merges_and_ranks(tmp_path, monkeypatch):
    monkeypatch.setattr(port_fid, "extract_features", _cheap_features)
    monkeypatch.setattr(port_fid.os, "cpu_count", lambda: 1)  # the distances in this process
    rng = np.random.RandomState(3)
    good = convergence_probe.make_textured_images(rng, rng.randint(0, 4, 24))
    blurred = good.astype(np.float32)
    blurred = (blurred + np.roll(blurred, 1, 1) + np.roll(blurred, -1, 1)
               + np.roll(blurred, 1, 2) + np.roll(blurred, -1, 2)) / 5.0
    for name, imgs in (("ddpm", good), ("cache", blurred.astype(np.uint8))):
        (tmp_path / name).mkdir()
        for i, im in enumerate(imgs):
            Image.fromarray(im).save(tmp_path / name / f"{i}.png")
        Image.fromarray(imgs[0]).save(tmp_path / name / "0_500.png")  # an intermediate
    (tmp_path / "quality_matrix.json").write_text(
        json.dumps({"ddpm": {"n_samples": 24}, "cache": {"n_samples": 24}}))
    table = score_quality.main([
        "--out", str(tmp_path), "--distribution", "textured", "--ref_n", "48",
        "--batch_size", "8", "--device", "cpu"])
    rows = table["rows"]
    assert list(rows) == sorted(rows, key=lambda k: rows[k]["fd_rand_vs_dense"])
    assert set(rows) == {"real_vs_real", "ddpm", "cache"}
    assert rows["ddpm"]["n"] == rows["cache"]["n"] == 24
    assert abs(rows["ddpm"]["fd_rand_vs_dense"]) < 1e-6 and rows["ddpm"]["spec_vs_dense"] == 0
    assert rows["cache"]["fd_rand_vs_dense"] > 3 * rows["real_vs_real"]["fd_rand_vs_dense"]
    assert rows["cache"]["spec_vs_dense"] > 4 * rows["real_vs_real"]["spec_vs_dense"]
    qm = json.loads((tmp_path / "quality_matrix.json").read_text())
    assert qm["cache"]["n_samples"] == 24 and "fd_rand_vs_real" in qm["cache"]
    assert json.loads((tmp_path / "fd_table.json").read_text())["rows"] == rows


# the JAX tool's rows (tools/trajectory_parity.py, non-smoke, base "fused",
# with --cache_schedule) and their kinds; the port renames the determinism
# row (no "/threefry"), drops "rng rbg vs threefry" and adds two rows
JAX_PARITY_ROWS = {
    "determinism fused/threefry (rerun)": "numerics",
    "attn xla vs fused": "numerics",
    "attn pallas vs fused": "numerics",
    "gelu tanh vs exact (fused)": "numerics",
    "attn fused_int8 vs fused": "quantization",
    "rng rbg vs threefry": "stream-change",
    "block-cache every=3 vs dense": "algorithmic",
    "block-cache every=5 vs dense": "algorithmic",
    "block-cache every=3 + int8 vs dense": "quantization+algorithmic",
    "block-cache derived vs dense": "algorithmic",
    "block-cache derived + int8 vs dense": "quantization+algorithmic",
    "DPM-20 vs DDPM-1000 (shared x_init)": "solver+stochasticity",
    "DPM-20 cached every=3 vs DPM-20 dense": "algorithmic",
    "static buckets vs dynamic thr=0.08": "algorithmic",
}


def test_trajectory_parity_rows_are_jax_s(tmp_path):
    (tmp_path / "tiny.yaml").write_text(TINY.format(depth=5, extra=""))
    (tmp_path / "ee.yaml").write_text(TINY.format(
        depth=13, extra="  classifier_type: mlp_probe_per_layer\n"))
    steps = 10
    save_cache_schedule(tmp_path / "sched.json", np.arange(steps) % 4 == 0)
    out = trajectory_parity.main([
        "--batch", "1", "--steps", str(steps), "--chunk", "5", "--config",
        str(tmp_path / "tiny.yaml"), "--ee_config", str(tmp_path / "ee.yaml"),
        "--cache_schedule", str(tmp_path / "sched.json"), "--out", str(tmp_path / "tp.json"),
        "--device", "cpu"])
    want = {k.replace("/threefry", ""): v for k, v in JAX_PARITY_ROWS.items()
            if not k.startswith("rng ")}
    want.update({"attn plain vs fused": "numerics",
                 "block-cache every=5 + int8 vs dense": "quantization+algorithmic"})
    rows = out["rows"]
    assert {k: r["kind"] for k, r in rows.items()} == want
    # on the CPU every wrapper takes its plain version: fused is plain, and reruns are equal
    assert rows["attn plain vs fused"]["terminal_max_err"] == 0.0
    assert rows["determinism fused (rerun)"]["terminal_max_err"] == 0.0
    assert len(rows["block-cache every=3 vs dense"]["traj_max_err"]) == steps // 5
    assert 0 < rows["block-cache every=5 vs dense"]["terminal_max_err"]
    assert all(r["launches"] == {} for r in rows.values())
    on_disk = json.loads((tmp_path / "tp.json").read_text())
    assert on_disk["rows"]["determinism fused (rerun)"]["terminal_psnr"] == "inf"
    only = trajectory_parity.main([
        "--batch", "1", "--steps", str(steps), "--chunk", "5", "--config",
        str(tmp_path / "tiny.yaml"), "--only", "DPM-20 cached", "--out",
        str(tmp_path / "tp.json"), "--device", "cpu"])
    assert set(only["rows"]) == set(rows)  # merged into what was there


def test_probe_cache_gamma_candidates_follow_jax_s_derivation(tmp_path):
    (tmp_path / "tiny.yaml").write_text(TINY.format(depth=5, extra=""))
    steps = 20
    drift = np.random.RandomState(0).rand(steps) * np.linspace(2, 0.2, steps)
    save_cache_schedule(tmp_path / "drift.json", np.zeros(steps, bool),
                        meta={"drift": drift.tolist(), "config": "tiny"})
    result = probe_cache_gamma.main([
        "--drift_json", str(tmp_path / "drift.json"), "--config", str(tmp_path / "tiny.yaml"),
        "--steps", str(steps), "--batch", "1", "--gammas", "0,1", "--ref_every", "5",
        "--out", str(tmp_path / "best.json"), "--device", "cpu"])
    rows = result["rows"]
    assert set(rows) == {"uniform_3", "uniform_5", "gamma_0", "gamma_1"}
    betas = np.asarray(JaxSchedule.create(steps=steps).betas, np.float64)
    alphas = 1.0 - betas
    abar = np.cumprod(alphas)
    w = betas / np.sqrt(1 - abar) / np.sqrt(alphas) / np.sqrt(abar / alphas)
    for g in (0.0, 1.0):
        signal = drift * w ** g
        table = jax_derive(signal, jax_budget(signal, 3))
        assert rows[f"gamma_{g:g}"]["anchors"] == int(table.sum())
    assert rows["uniform_3"]["anchors"] == 7 and rows["uniform_5"]["anchors"] == 4
    assert all(np.isfinite(r["max_err"]) and r["max_err"] > 0 for r in rows.values())
    if result["best"] is not None:
        assert json.loads((tmp_path / "best.json").read_text())["meta"]["probe"] == result["best"]


def test_fid_cli_saves_and_reuses_real_stats(probe_run, tmp_path, monkeypatch):
    """The whole CLI once (one 2048 x 2048 square root, tens of seconds on
    the CPU); the rerun on the saved statistics hands the distance exactly
    what the first run computed."""
    data = Path(probe_run["workdir"]) / "data"
    samples = Path(probe_run["workdir"]) / "samples"
    stats = tmp_path / "stats.npz"
    common = ["--dataset", "cifar10", "--data_path", str(data), "--samples_path", str(samples),
              "--inception_weights", "random-init", "--batch_size", "2", "--device", "cpu"]
    seen = []
    real = port_fid.frechet_distance
    monkeypatch.setattr(port_fid, "frechet_distance",
                        lambda *args: seen.append(args) or real(*args))
    first = fid_cli.main(common + ["--save_real_stats", str(stats)])
    assert np.isfinite(first) and np.load(stats)["sigma"].shape == (2048, 2048)
    monkeypatch.setattr(port_fid, "frechet_distance", lambda *args: seen.append(args) or first)
    assert fid_cli.main(common + ["--real_stats", str(stats)]) == first
    for a, b in zip(*seen):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("tool", ["fid", "score_quality", "quality_matrix", "convergence_probe",
                                  "t_switch_sweep", "trajectory_parity", "probe_cache_gamma"])
def test_cuda_without_a_card_is_refused(tool, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = {
        "fid": ["--dataset", "cifar10", "--samples_path", str(tmp_path)],
        "score_quality": ["--out", str(tmp_path)],
        "quality_matrix": ["--config", "c.yaml", "--checkpoint", "c.pth", "--out",
                           str(tmp_path)],
        "convergence_probe": ["--workdir", str(tmp_path)],
        "t_switch_sweep": ["--config_path", "a", "--config_path_late", "b", "--real_stats",
                           "s", "--inception_weights", "random-init"],
        "trajectory_parity": [],
        "probe_cache_gamma": ["--drift_json", str(tmp_path / "d.json")],
    }[tool]
    (tmp_path / "d.json").write_text(json.dumps({"meta": {"drift": [0.0] * 1000}}))
    main = fid_cli.main if tool == "fid" else sys.modules[
        f"duodiff_tpu_torch.tools.{tool}"].main
    with pytest.raises(SystemExit, match="no CUDA device"):
        main(argv + ["--device", "cuda"])
