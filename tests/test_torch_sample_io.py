"""What the sampling CLI reads and writes beyond ``samples.npy``
(``python -m duodiff_tpu_torch.sample``, run in-process on the CPU at tiny
configs): ``--use_ema`` on checkpoints the port's trainer wrote, the PNG writer
(``duodiff_tpu_torch.utils.image``) against its own decoding, Pillow's and
the files ``duodiff_tpu.utils.image`` writes, and ``--timesteps_save``
against the unbroken loop on the same generator.

Everything here is exact: the same pixels, the same bits.
"""

import struct
import zlib

import numpy as np
import pytest
import torch

from duodiff_tpu_torch import sample, train
from duodiff_tpu_torch.data.synthetic import write_palette_cifar
from duodiff_tpu_torch.diffusion.sampling import duodiff_sample
from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
from duodiff_tpu_torch.training.checkpointer import CHECKPOINT_FILE
from duodiff_tpu_torch.utils import image
from duodiff_tpu_torch.utils.model_loading import load_model

torch.set_num_threads(1)

TINY = dict(img_size=32, patch_size=4, in_chans=3, embed_dim=32, num_heads=4, mlp_ratio=4,
            qkv_bias=False, mlp_time_embed=False, num_classes=-1, normalize_timesteps=True)
STEPS, T_SWITCH = 20, 5


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("sample_io")
    write_palette_cifar(d / "data", seed=0, per_batch=32)
    out = {"data": str(d / "data"), "logs": str(d / "logs"), "dir": d}
    for depth in (3, 5):
        path = d / f"tiny{depth}.yaml"
        path.write_text("model_params:\n" + "".join(
            f"  {k}: {v}\n" for k, v in dict(TINY, depth=depth).items()))
        out[f"config{depth}"] = str(path)
    return out


def _sample_argv(files, out, *extra, late=True):
    argv = ["--device", "cpu", "--config_path", files["config3"], "--num_timesteps", str(STEPS),
            "--batch_size", "3", "--parametrization", "predict_noise", "--output_folder",
            str(out), "--seed", "4"]
    if late:
        argv += ["--config_path_late", files["config5"], "--t_switch", str(T_SWITCH)]
    return argv + list(extra)


# --- --use_ema ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def checkpoints(files):
    """Depth-3 and depth-5 checkpoints of three training steps with an EMA,
    a depth-3 one without, and by-hand copies whose weights are the EMA's."""
    out = {}
    for depth, ema in ((3, True), (5, True), (3, False)):
        name = f"d{depth}{'_ema' if ema else ''}"
        argv = ["--config_path", files[f"config{depth}"], "--device", "cpu", "--data_path",
                files["data"], "--log_path", files["logs"], "--exp_name", name, "--n_steps", "3",
                "--batch_size", "8", "--num_warmup_steps", "1", "--lr", "1e-2", "--seed", "0"]
        trainer = train.main(argv + (["--ema_decay", "0.5"] if ema else []))
        out[name] = str(trainer.log_path / "cifar10_uvit_last" / CHECKPOINT_FILE)
        if ema:
            state = torch.load(out[name], map_location="cpu", weights_only=True)
            by_hand = files["dir"] / f"{name}_by_hand.pth"
            torch.save({"model_state_dict": state["ema_state_dict"]}, by_hand)
            out[f"{name}_by_hand"] = str(by_hand)
    return out


def test_load_model_use_ema(files, checkpoints):
    state = torch.load(checkpoints["d3_ema"], map_location="cpu", weights_only=True)
    ema, _ = load_model(files["config3"], checkpoints["d3_ema"], device="cpu", use_ema=True)
    live, _ = load_model(files["config3"], checkpoints["d3_ema"], device="cpu")
    differs = 0
    for k, v in ema.state_dict().items():
        assert torch.equal(v, state["ema_state_dict"][k])
        assert torch.equal(live.state_dict()[k], state["model_state_dict"][k])
        differs += not torch.equal(v, live.state_dict()[k])
    assert differs > 0  # three steps at decay 0.5: the shadow trails the weights
    with pytest.raises(ValueError, match="no EMA params"):
        load_model(files["config3"], checkpoints["d3"], device="cpu", use_ema=True)


@pytest.mark.parametrize("pair", [False, True])
def test_use_ema_samples_with_the_ema_weights(files, checkpoints, tmp_path, pair):
    def run(early, late, *extra):
        argv = _sample_argv(files, tmp_path, "--checkpoint_path", checkpoints[early], *extra,
                            late=pair)
        if pair:
            argv += ["--checkpoint_path_late", checkpoints[late]]
        return sample.main(argv)["samples"]

    with_flag = run("d3_ema", "d5_ema", "--use_ema")
    np.testing.assert_array_equal(with_flag, run("d3_ema_by_hand", "d5_ema_by_hand"))
    assert not np.array_equal(with_flag, run("d3_ema", "d5_ema"))


def test_use_ema_without_an_ema_is_refused(files, checkpoints, tmp_path):
    with pytest.raises(ValueError, match="saved without --ema_decay"):
        sample.main(_sample_argv(files, tmp_path, "--checkpoint_path", checkpoints["d3"],
                                 "--use_ema", late=False))
    with pytest.raises(ValueError, match="saved without --ema_decay"):  # the late model's
        sample.main(_sample_argv(files, tmp_path, "--checkpoint_path", checkpoints["d3_ema"],
                                 "--checkpoint_path_late", checkpoints["d3"], "--use_ema",
                                 "--config_path_late", files["config3"]))


# --- the PNG writer ----------------------------------------------------------------


def _decode_png(data: bytes) -> np.ndarray:
    """A reader for what the writer may emit: 8-bit greyscale or RGB, no
    interlace, filter type 0 on every row; checks every chunk's CRC."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, []
    while pos < len(data):
        (length,), kind = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        assert crc == zlib.crc32(kind + body), kind
        chunks.append((kind, body))
        pos += 12 + length
    assert [k for k, _ in chunks][0] == b"IHDR" and chunks[-1] == (b"IEND", b"")
    w, h, depth, color, comp, filt, lace = struct.unpack(">IIBBBBB", chunks[0][1])
    assert (depth, comp, filt, lace) == (8, 0, 0, 0) and color in (0, 2)
    c = 3 if color == 2 else 1
    raw = zlib.decompress(b"".join(body for kind, body in chunks if kind == b"IDAT"))
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + w * c)
    assert not rows[:, 0].any()  # filter type 0
    return rows[:, 1:].reshape(h, w, c)


def _images(channels, seed=0):
    rng = np.random.RandomState(seed)
    samples = rng.uniform(-0.2, 1.2, size=(5, 12, 10, channels)).astype(np.float32)
    samples[0, 0, 0] = np.nan
    samples[1, 0, 0] = np.inf
    samples[2, 0, 0] = -np.inf
    return samples


@pytest.mark.parametrize("channels", [3, 1])
def test_png_files_decode_to_the_uint8_samples(tmp_path, channels):
    samples = _images(channels)
    image.save_samples(samples, tmp_path)
    image.save_samples(samples, tmp_path, timestep=300, with_grid=False)
    want = image.to_uint8(samples)
    assert want[0, 0, 0].max() == 0 and want[1, 0, 0].min() == 255 and want[2, 0, 0].max() == 0
    for i in range(len(samples)):
        for name in (f"{i}.png", f"{i}_300.png"):
            np.testing.assert_array_equal(_decode_png((tmp_path / name).read_bytes()), want[i])
    grid = _decode_png((tmp_path / "grid_image.png").read_bytes())
    assert grid.shape == (3 * 12, 3 * 10, channels)  # ceil(sqrt(5)) = 3 a side
    np.testing.assert_array_equal(grid, image.to_uint8(image.make_grid(samples)))
    np.testing.assert_array_equal(grid[12:24, 10:20], want[4])  # sample 4: row 1, column 1
    assert not grid[24:].any()                                  # the unfilled last row
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        [f"{i}.png" for i in range(5)] + [f"{i}_300.png" for i in range(5)] + ["grid_image.png"])


@pytest.mark.parametrize("channels", [3, 1])
def test_png_files_hold_the_pixels_the_jax_package_writes(tmp_path, channels):
    Image = pytest.importorskip("PIL.Image")
    from duodiff_tpu.utils import image as jax_image

    samples = _images(channels, seed=1)
    np.testing.assert_array_equal(image.to_uint8(samples), jax_image.to_uint8(samples))
    np.testing.assert_array_equal(image.make_grid(samples), jax_image.make_grid(samples))
    image.save_samples(samples, tmp_path / "port", timestep=7)
    jax_image.save_samples(samples, tmp_path / "jax", timestep=7)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    for name in names:
        ours, theirs = Image.open(tmp_path / "port" / name), Image.open(tmp_path / "jax" / name)
        assert ours.mode == theirs.mode == ("RGB" if channels == 3 else "L")
        np.testing.assert_array_equal(np.asarray(ours), np.asarray(theirs))
        # and Pillow reads from our file what our own reader reads
        own = _decode_png((tmp_path / "port" / name).read_bytes())
        np.testing.assert_array_equal(np.asarray(ours).reshape(own.shape), own)


def test_png_encoder_refuses_what_it_cannot_write():
    for bad in (np.zeros((4, 4, 2), np.uint8), np.zeros((4, 4, 3), np.float32),
                np.zeros((4,), np.uint8)):
        with pytest.raises(ValueError, match="a PNG takes"):
            image.encode_png(bad)
    assert _decode_png(image.encode_png(np.arange(12, dtype=np.uint8).reshape(3, 4))).shape == (
        3, 4, 1)


# --- --timesteps_save --------------------------------------------------------------


def test_split_segments():
    a, b = object(), object()
    segs = [(a, 19, 15), (b, 14, 0)]
    assert sample.split_segments(segs, set()) == segs
    assert sample.split_segments(segs, {15, 0}) == segs  # already segment ends
    assert sample.split_segments(segs, {17, 19, 8}) == [
        (a, 19, 19), (a, 18, 17), (a, 16, 15), (b, 14, 8), (b, 7, 0)]
    assert sample.split_segments([(a, 19, 20), (b, 19, 0)], {20, 3}) == [
        (a, 19, 20), (b, 19, 3), (b, 2, 0)]  # an empty segment stays as it is


def test_timesteps_save_keeps_the_samples_and_the_loops_states(files, tmp_path):
    """Saves inside the early segment (3), at the handoff (5), inside the late
    segment (12) and at the end (20): the final samples equal the run
    without, to the bit, and each kept state is the unbroken two-model loop's
    x after that many updates on the same generator."""
    saves = [5, 20, 12, 3]
    plain = sample.main(_sample_argv(files, tmp_path / "plain", "--random_init"))
    saved = sample.main(_sample_argv(files, tmp_path / "saved", "--random_init",
                                     "--timesteps_save", *map(str, saves)))
    np.testing.assert_array_equal(saved["samples"], plain["samples"])
    assert plain["intermediates"] == {} and list(saved["intermediates"]) == saves

    # the unbroken loop: each model call's input is the state after the update before it
    seen = {}
    models = []
    for config, seed in ((files["config3"], 4), (files["config5"], 5)):
        model, cfg = load_model(config, device="cpu", seed=seed, attn_impl="plain")
        model.pack_for_kernels()
        model.eval()

        def apply(x, t, y, model=model):
            seen[int(t[0]) + 1] = x.clone()
            return model(x, t, y)

        models.append(apply)
    with torch.no_grad():
        final = duodiff_sample(*models, torch.Generator().manual_seed(4),
                               schedule=NoiseSchedule.create(steps=STEPS, device="cpu"),
                               shape=(3, cfg.img_size, cfg.img_size, cfg.in_chans),
                               t_switch=T_SWITCH)
    seen[0] = final
    np.testing.assert_array_equal(((final + 1.0) / 2.0).numpy(), plain["samples"])
    for s in saves:
        want = ((seen[STEPS - s] + 1.0) / 2.0).numpy()
        np.testing.assert_array_equal(saved["intermediates"][s], want)
        for i in range(3):
            np.testing.assert_array_equal(
                _decode_png((tmp_path / "saved" / f"{i}_{s}.png").read_bytes()),
                image.to_uint8(want[i]))
    for i in range(3):
        np.testing.assert_array_equal(
            _decode_png((tmp_path / "saved" / f"{i}.png").read_bytes()),
            image.to_uint8(plain["samples"][i]))
    np.testing.assert_array_equal(np.load(tmp_path / "saved" / "samples.npy"),
                                  image.to_uint8(plain["samples"]))
    assert (tmp_path / "saved" / "grid_image.png").exists()
    assert "Elapsed time" in (tmp_path / "saved" / "statistics.txt").read_text()


def test_timesteps_save_with_a_single_model(files, tmp_path):
    plain = sample.main(_sample_argv(files, tmp_path, "--random_init", late=False))
    saved = sample.main(_sample_argv(files, tmp_path, "--random_init", "--timesteps_save", "1",
                                     "20", late=False))
    np.testing.assert_array_equal(saved["samples"], plain["samples"])
    np.testing.assert_array_equal(saved["intermediates"][20], plain["samples"])
    assert not np.array_equal(saved["intermediates"][1], plain["samples"])


TIMESTEP_REFUSALS = {
    "zero": (["--timesteps_save", "0"], r"each in \[1, 20\]"),
    "past_the_end": (["--timesteps_save", "5", "21"], r"each in \[1, 20\]: got \[21\]"),
    "with_cache_every": (["--timesteps_save", "5", "--cache_every", "2"],
                         "does not support --timesteps_save"),
}


@pytest.mark.parametrize("name", sorted(TIMESTEP_REFUSALS))
def test_timesteps_save_refusals(files, tmp_path, name):
    extra, match = TIMESTEP_REFUSALS[name]
    with pytest.raises(SystemExit, match=match):
        sample.main(_sample_argv(files, tmp_path, "--random_init", *extra))
