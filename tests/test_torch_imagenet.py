"""The port's class-conditional path (the ImageNet-64 family) against the
JAX package at a small size: D = 128 with 2 heads of 64, 16 patches + time
and label tokens (L = 18), depth 3 and 5, 10 classes. Inputs come from a
seed with numpy; weights are JAX-initialised, perturbed, and carried across
by the port's own converter. The JAX model runs attn_impl="pallas" (its
attention kernels K9 / K10 in interpret mode on the CPU) or "xla".

Tolerances, each with its reason:
- fp32 forwards (block, model, cached forwards) 1e-4: the same arithmetic
  in another summation order;
- fp32 train-step loss 1e-6 and gradients rtol 1e-4 / atol 1e-6, as the
  fused train step's test holds them;
- bf16 gradients 2e-2 relative Frobenius per parameter: both sides round to
  bf16 at the same points, but XLA and PyTorch order their fp32 sums
  differently, which flips roundings (largest reading 1.6e-2,
  mid_block.attn.proj.bias). The 3-entry final_layer.bias alone is held at
  5e-2 (readings 2.9e-2 and 3.7e-2): it is the sum of the bf16 conv output's
  gradient over every pixel, which the two frameworks reduce in different
  precisions;
- the 20-step guided trajectory 1e-4: ~1e-6 per forward plus the update
  arithmetic of 20 ancestral steps.
"""

import ast
import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duodiff_tpu.config import UViTConfig as JaxConfig
from duodiff_tpu.data.cache import MemmapCachedDataset as JaxCachedDataset
from duodiff_tpu.data.loader import DataLoader as JaxDataLoader
from duodiff_tpu.data.sampler import ResumableSeedableSampler as JaxSampler
from duodiff_tpu.diffusion.sampling import duodiff_sample as jax_duodiff_sample
from duodiff_tpu.diffusion.sampling import make_guided_apply as jax_make_guided_apply
from duodiff_tpu.diffusion.schedule import NoiseSchedule as JaxSchedule
from duodiff_tpu.models.layers import Block as JaxBlock
from duodiff_tpu.models.uvit import init_uvit as jax_init_uvit
from duodiff_tpu.ops import pallas_block
from duodiff_tpu.training.train_state import make_train_step as jax_make_train_step
from duodiff_tpu.utils.param_layout import qkv_packed_to_heads
from duodiff_tpu.utils.torch_export import export_uvit as jax_export_uvit
from duodiff_tpu_torch.config import UViTConfig
from duodiff_tpu_torch.data.cache import CACHE_DIR, IMAGENET64_KEY, MemmapCachedDataset
from duodiff_tpu_torch.data.datasets import get_dataloader
from duodiff_tpu_torch.data.synthetic import write_palette_imagenet64_cache
from duodiff_tpu_torch.diffusion.sampling import duodiff_sample, make_guided_apply
from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
from duodiff_tpu_torch.models.layers import Block
from duodiff_tpu_torch.models.uvit import UViT
from duodiff_tpu_torch.ops import block as block_ops
from duodiff_tpu_torch.training.train_state import make_train_step
from duodiff_tpu_torch.utils import convert

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(img_size=16, patch_size=4, in_chans=3, embed_dim=128, num_heads=2, mlp_ratio=4,
             num_classes=10, normalize_timesteps=False)
D, HEADS, L = 128, 2, 18
NULL = 9


def _perturbed(params, seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.02 * rng.randn(*a.shape).astype(np.float32), params)


def _jax_model(depth, seed, dtype=jnp.float32, **kw):
    model, params = jax_init_uvit(JaxConfig(**dict(SMALL, depth=depth)),
                                  jax.random.PRNGKey(seed), dtype=dtype, **kw)
    return model, _perturbed(params, seed)


def _port_model(depth, params, dtype=torch.float32, **kw):
    model = UViT(UViTConfig(**dict(SMALL, depth=depth)), dtype=dtype, **kw)
    model.load_state_dict(convert.uvit_state_dict_from_jax(params), strict=True)
    model.pack_for_kernels()
    return model


def _batch(seed, b=2):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, 16, 16, 3).astype(np.float32)
    t = rng.randint(0, 1000, b).astype(np.float32)
    y = rng.randint(0, NULL, b).astype(np.int32)
    return x, t, y


# --- the converter stands alone -------------------------------------------------


@pytest.mark.parametrize("layout", ["packed", "heads"])
def test_own_export_equals_the_jax_packages(layout):
    """The port's copy of export_uvit against the JAX package's, key by key
    and bit by bit, on a class-conditional tree in both qkv layouts."""
    _, params = _jax_model(3, 0)
    if layout == "heads":
        params = qkv_packed_to_heads(params, num_heads=HEADS)
        assert params["mid_block"]["attn"]["qkv"]["kernel"].ndim == 4
    want = jax_export_uvit(params)
    got = convert.export_uvit(params)
    assert list(got) == list(want) and "label_emb.weight" in got
    for key, value in want.items():
        assert got[key].dtype == np.float32 and np.array_equal(got[key], value), key


def _imports(path: Path):
    """Every module name a source imports, at module level or inside a function."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("where", ["duodiff_tpu_torch", "chip_smoke.py"])
def test_no_source_imports_the_jax_package(where):
    root = REPO / where
    sources = sorted(root.rglob("*.py")) if root.is_dir() else [root]
    assert sources
    banned = {"duodiff_tpu", "jax", "jaxlib", "flax", "yaml", "PIL"}
    for source in sources:
        bad = sorted({m for m in _imports(source) if m.split(".")[0] in banned})
        assert not bad, f"{source.relative_to(REPO)} imports {bad}"


# --- the unfused block and the class-conditional model --------------------------


def _block_state(params):
    sd = {}
    convert._block(sd, params, "b")
    return {k[2:]: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


@pytest.mark.parametrize("skip", [False, True], ids=["noskip", "skip"])
@pytest.mark.parametrize("impl, mlp_impl", [("pallas", "auto"), ("xla", "auto"),
                                            ("pallas", "fused")])
def test_unfused_block_matches_jax(impl, mlp_impl, skip):
    rng = np.random.RandomState(1)
    x = rng.randn(2, L, D).astype(np.float32)
    s = rng.randn(2, L, D).astype(np.float32) if skip else None
    jblock = JaxBlock(num_heads=HEADS, skip=skip, attn_impl=impl, mlp_impl=mlp_impl,
                      qkv_bias=True)
    args = (jnp.asarray(x),) + ((jnp.asarray(s),) if skip else ())
    params = _perturbed(jblock.init(jax.random.PRNGKey(2), *args)["params"], 2)
    want = np.asarray(jblock.apply({"params": params}, *args))
    block = Block(D, HEADS, qkv_bias=True, skip=skip, attn_impl=impl, mlp_impl=mlp_impl)
    block.load_state_dict(_block_state(params), strict=True)
    block.pack(torch.float32)
    with torch.no_grad():
        got = block.eval()(torch.from_numpy(x), None if s is None else torch.from_numpy(s))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    # training mode reads the same live parameters; the fused MLP trains in bf16 only
    train_args = (torch.from_numpy(x), None if s is None else torch.from_numpy(s))
    if mlp_impl == "fused":
        with pytest.raises(ValueError, match="bf16 only"):
            block.train()(*train_args)
    else:
        assert torch.allclose(block.train()(*train_args), got, atol=1e-6)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_class_conditional_forward_matches_jax(impl):
    jmodel, params = _jax_model(5, 3, attn_impl=impl)
    x, t, y = _batch(4)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                                   jnp.asarray(y)))
    model = _port_model(5, params, attn_impl=impl)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x), torch.from_numpy(t),
                           torch.from_numpy(y).long())
    assert got.shape == want.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="requires labels"), torch.no_grad():
        model(torch.from_numpy(x), torch.from_numpy(t))


def test_cached_forwards_work_with_the_unfused_block():
    jmodel, params = _jax_model(5, 5, attn_impl="pallas")
    x, t, y = _batch(6)
    jx, jt, jy = jnp.asarray(x), jnp.asarray(t), jnp.asarray(y)
    want, jdelta = jmodel.apply({"params": params}, jx, jt, jy, n_outer=1,
                                method=jmodel.forward_anchor)
    want_cached = jmodel.apply({"params": params}, jx, jt, jy, n_outer=1, delta=jdelta,
                               method=jmodel.forward_cached)
    model = _port_model(5, params, attn_impl="pallas").eval()
    tx, tt, ty = torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y).long()
    with torch.no_grad():
        got, delta = model.forward_anchor(tx, tt, ty, n_outer=1)
        cached = model.forward_cached(tx, tt, ty, n_outer=1, delta=delta)
        assert torch.equal(got, model(tx, tt, ty))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(delta.numpy(), np.asarray(jdelta), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(cached.numpy(), np.asarray(want_cached), rtol=1e-4, atol=1e-4)


def test_block_rejects_unknown_impls():
    with pytest.raises(ValueError, match="attn_impl must be one of"):
        Block(D, HEADS, attn_impl="auto")
    with pytest.raises(ValueError, match="mlp_impl must be one of"):
        Block(D, HEADS, attn_impl="pallas", mlp_impl="plain")
    block = Block(D, HEADS, attn_impl="pallas", mlp_impl="fused").eval()
    with pytest.raises(RuntimeError, match="pack_for_kernels"), torch.no_grad():
        block(torch.zeros(1, L, D))


# --- the train step ------------------------------------------------------------


@pytest.mark.parametrize("label_dropout", [0.0, 0.5], ids=["nodrop", "drop"])
@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
def test_pallas_train_step_gradients_match_jax(dtype_name, label_dropout):
    """Loss and every gradient of a train step with attn_impl="pallas"
    against JAX's make_train_step (K9 forward, K10 backward in interpret
    mode). The timesteps, the noise and the label-drop mask are JAX's own
    draws, injected into the port: the RNG streams cannot match."""
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype_name]
    jmodel, params = _jax_model(3, 7, dtype=jdt, attn_impl="pallas")
    jstep = jax_make_train_step(
        lambda p, x, t, y: jmodel.apply({"params": p}, x, t, y), JaxSchedule.create(steps=1000),
        model_kind="uvit", parametrization="predict_noise", has_labels=True,
        label_dropout=label_dropout, null_label=NULL)
    x, _, y = _batch(8, b=4)
    x = np.clip(x, -1, 1)
    key = jax.random.PRNGKey(9)
    batch = {"image": jnp.asarray(x), "label": jnp.asarray(y)}
    (loss, _), grads = jax.value_and_grad(jstep.loss_fn, has_aux=True)(params, batch, key)
    want = convert.uvit_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads))

    t_key, n_key = jax.random.split(key)
    timesteps = torch.from_numpy(np.asarray(jax.random.randint(t_key, (4,), 0, 1000))).long()
    noise = torch.from_numpy(np.asarray(jax.random.normal(n_key, x.shape, jnp.float32)).copy())
    drop = None
    if label_dropout:
        d_key = jax.random.fold_in(key, 0x1ABE1)
        drop = torch.from_numpy(np.asarray(jax.random.bernoulli(d_key, label_dropout, (4,))))
        assert drop.any() and not drop.all()

    model = _port_model(3, params, dtype=tdt, attn_impl="pallas")
    step = make_train_step(model, NoiseSchedule.create(steps=1000),
                           parametrization="predict_noise", seed=0, has_labels=True,
                           label_dropout=label_dropout,
                           null_label=NULL if label_dropout else None)
    tbatch = {"image": torch.from_numpy(x), "label": torch.from_numpy(y).long()}
    metrics, got = step.backward(tbatch, timesteps, noise, drop)
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(want)
    if dtype_name == "fp32":
        assert abs(metrics["train_loss"].item() - float(loss)) <= 1e-6
        for name, g in zip(names, got):
            np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=name)
    else:
        assert abs(metrics["train_loss"].item() / float(loss) - 1) <= 1e-3
        for name, g in zip(names, got):
            w = want[name].numpy()
            bound = 5e-2 if name == "final_layer.bias" else 2e-2
            assert np.linalg.norm(g.float().numpy() - w) / np.linalg.norm(w) <= bound, name


def test_label_dropout_leaves_the_other_draws_alone():
    """The drop mask is a function of (seed, step) from a generator of its
    own: timesteps and noise are those of a label_dropout=0 run to the bit,
    and dropped labels become the null label."""
    model = UViT(UViTConfig(**dict(SMALL, depth=3)), dtype=torch.float32, attn_impl="xla")
    sched = NoiseSchedule.create(steps=1000)
    kw = dict(parametrization="predict_noise", seed=3, has_labels=True)
    plain = make_train_step(model, sched, **kw)
    cfg = make_train_step(model, sched, label_dropout=0.5, null_label=NULL, **kw)
    batch = {"image": torch.zeros(64, 16, 16, 3), "label": torch.arange(64) % NULL}
    for a, b in zip(plain.draws(batch, 5), cfg.draws(batch, 5)):
        assert torch.equal(a, b)
    assert plain.drop_mask(batch, 5) is None
    mask = cfg.drop_mask(batch, 5)
    assert torch.equal(mask, cfg.drop_mask(batch, 5))
    assert not torch.equal(mask, cfg.drop_mask(batch, 6))
    assert 16 <= int(mask.sum()) <= 48
    seen = []
    model.forward = lambda x, t, y=None: seen.append(y) or torch.zeros_like(x)
    cfg.loss_fn(batch, *cfg.draws(batch, 5), mask)
    assert torch.equal(seen[0], torch.where(mask, torch.tensor(NULL), batch["label"]))
    with pytest.raises(ValueError, match="null_label"):
        make_train_step(model, sched, label_dropout=0.5, **kw)


@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
def test_k6_plain_matches_the_flash_route_jax_takes_at_wide_models(dtype_name):
    """At D >= 768 JAX's fused training runs its attention backward as
    jax.vjp of _attn_sublayer_reference(sdpa="flash") (K9 + K10 inside an
    XLA chain) because K6 does not fit the TPU's VMEM. The port keeps K6
    there; this holds K6's plain version to that route's gradients."""
    jdt, tdt, tol = {"fp32": (jnp.float32, torch.float32, 2e-4),
                     "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}[dtype_name]
    rng = np.random.RandomState(10)
    b, l = 3, 33
    x, dy = rng.randn(b, l, D).astype(np.float32), rng.randn(b, l, D).astype(np.float32)
    ln_s = (1.0 + 0.1 * rng.randn(D)).astype(np.float32)
    ln_b = (0.1 * rng.randn(D)).astype(np.float32)
    wqkv = (0.05 * rng.randn(D, 3 * D)).astype(np.float32)
    bqkv = (0.05 * rng.randn(3 * D)).astype(np.float32)
    wp = (0.05 * rng.randn(D, D)).astype(np.float32)
    bp = (0.05 * rng.randn(D)).astype(np.float32)
    jargs = (jnp.asarray(x).astype(jdt), *map(jnp.asarray, (ln_s, ln_b, wqkv, bqkv, wp, bp)))
    _, vjp = jax.vjp(functools.partial(pallas_block._attn_sublayer_reference, num_heads=HEADS,
                                       eps=1e-5, sdpa="flash", interpret=True), *jargs)
    want = vjp(jnp.asarray(dy).astype(jdt))
    t = torch.from_numpy
    got = block_ops.attn_sublayer_bwd_plain(
        t(x).to(tdt), t(dy).to(tdt), t(ln_s), t(ln_b), t(wqkv).to(tdt), t(bqkv),
        t(wp).to(tdt), num_heads=HEADS)
    for name, g, w in zip(("dx", "dln_s", "dln_b", "dwqkv", "dbqkv", "dwp", "dbp"), got, want):
        w = np.asarray(w.astype(jnp.float32))
        err = np.linalg.norm(g.float().numpy() - w) / np.linalg.norm(w)
        assert err <= tol, (name, err)


# --- guidance ------------------------------------------------------------------


def test_guided_apply_reduces_to_its_halves():
    def apply(x, t, y):
        return x * 0 + y.float()[:, None, None, None] + t[:, None, None, None]

    x, t = torch.zeros(3, 2, 2, 1), torch.tensor([1.0, 2.0, 3.0])
    y = torch.tensor([4, 5, 6])
    cond, null = apply(x, t, y), apply(x, t, torch.full_like(y, NULL))
    assert torch.equal(make_guided_apply(apply, 1.0, NULL)(x, t, y), cond)
    assert torch.equal(make_guided_apply(apply, 0.0, NULL)(x, t, y), null)
    assert torch.allclose(make_guided_apply(apply, 3.0, NULL)(x, t, y), null + 3.0 * (cond - null))
    lead = make_guided_apply(lambda scale, x, t, y: scale * apply(x, t, y), 1.0, NULL)
    assert torch.equal(lead(2.0, x, t, y), 2.0 * cond)
    with pytest.raises(ValueError, match="labels"):
        make_guided_apply(apply, 1.0, NULL)(x, t, None)


def test_guided_duodiff_trajectory_matches_jax():
    steps, t_switch, w = 20, 6, 1.5
    pairs = []
    for depth, seed in ((3, 11), (5, 12)):
        jmodel, params = _jax_model(depth, seed, attn_impl="pallas")
        japply = (lambda m, p: lambda x, t, y: m.apply({"params": p}, x, t, y))(jmodel, params)
        pairs.append((jax_make_guided_apply(japply, w, NULL),
                      make_guided_apply(_port_model(depth, params, attn_impl="pallas").eval(),
                                        w, NULL)))
    rng = np.random.RandomState(13)
    shape = (2, 16, 16, 3)
    table = rng.randn(steps, *shape).astype(np.float32)
    table[0] = 0.0
    x0 = rng.randn(*shape).astype(np.float32)
    y = np.array([2, 7], np.int32)
    want = jax_duodiff_sample(
        pairs[0][0], pairs[1][0], jax.random.PRNGKey(0), schedule=JaxSchedule.create(steps=steps),
        shape=shape, t_switch=t_switch, y=jnp.asarray(y), x_init=jnp.asarray(x0),
        noise_table=jnp.asarray(table))
    with torch.no_grad():
        got = duodiff_sample(
            pairs[0][1], pairs[1][1], None, schedule=NoiseSchedule.create(steps=steps),
            shape=shape, t_switch=t_switch, y=torch.from_numpy(y).long(),
            x_init=torch.from_numpy(x0), noise_table=torch.from_numpy(table))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


# --- the ImageNet-64 cache -----------------------------------------------------


class _FloatImages:
    """A stand-in for the JAX package's resized ImageNet-64 folder dataset:
    float32 HWC items in 0..255, labels, and the normalising transform."""

    scale, offset = 2.0 / 255.0, -1.0

    def __init__(self, n=12):
        rng = np.random.RandomState(14)
        self.images = rng.uniform(0, 255, (n, 64, 64, 3)).astype(np.float32)
        self.labels = rng.randint(0, 7, n)

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, i):
        return self.images[i], int(self.labels[i])


def test_cache_reader_reads_what_the_jax_package_writes(tmp_path):
    base = _FloatImages()
    written = JaxCachedDataset(base, tmp_path / CACHE_DIR, IMAGENET64_KEY, num_workers=2,
                               verbose=False)
    ds = MemmapCachedDataset(tmp_path / CACHE_DIR / IMAGENET64_KEY, scale=base.scale,
                             offset=base.offset)
    assert len(ds) == len(written) == 12 and ds.num_real_classes == int(base.labels.max()) + 1
    for i in range(len(ds)):
        assert np.array_equal(ds[i][0], written[i][0]) and ds[i][1] == written[i][1]
    want = JaxDataLoader(written, 5, JaxSampler(len(written), seed=3), num_workers=2)
    got = get_dataloader("imagenet64", 5, 3, tmp_path)
    try:
        for _ in range(4):  # crosses an epoch boundary
            a, b = got.next_batch(), want.next_batch()
            assert np.array_equal(a["label"], b["label"])
            np.testing.assert_allclose(a["image"], b["image"], rtol=0, atol=1e-6)
            assert a["image"].dtype == np.float32 and a["image"].shape == (5, 64, 64, 3)
    finally:
        got.close()


def test_synthetic_cache_and_refusal_without_one(tmp_path):
    with pytest.raises(NotImplementedError, match="image decoding"):
        get_dataloader("imagenet64", 4, 0, tmp_path)
    final = write_palette_imagenet64_cache(tmp_path, n=32, seed=1)
    assert json.loads((final / "meta.json").read_text())["shape"] == [32, 64, 64, 3]
    loader = get_dataloader("imagenet64", 8, 0, tmp_path)
    try:
        batch = loader.next_batch()
    finally:
        loader.close()
    assert batch["image"].shape == (8, 64, 64, 3) and np.abs(batch["image"]).max() <= 1.0
    assert batch["label"].dtype == np.int32 and 0 <= batch["label"].min()
    assert batch["label"].max() < 999 and loader.dataset.num_real_classes <= 999
    (final / "labels.npy").unlink()
    np.save(final / "labels.npy", np.zeros(3, np.int32))
    with pytest.raises(ValueError, match="corrupt cache"):
        get_dataloader("imagenet64", 8, 0, tmp_path)
