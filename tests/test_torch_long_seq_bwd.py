"""The backward past 272 tokens, where the card's attention backward core
takes its blocked form (``csrc/attn_bwd_core.cuh``), against the JAX package
on the CPU, on the same inputs made from a seed with numpy and weights
crossed over by the port's converter:

- the plain versions of K6 and K10 at L = 290 and 1025 (a 17 x 17 and a
  32 x 32 image at patch 1), at head width 64 (D = 128, 2 heads) and 72
  (D = 144, 2 heads), fp32 and bf16, against the Pallas kernels
  (``pallas_block._attn_sublayer_bwd_impl``,
  ``pallas_attention._flash_attention_bwd_impl``) in interpret mode, and the
  backward measuring entry's plain core against the kernels' own;
- one train step of a depth-3 U-ViT at L = 1025 (32 x 32 x 3 at patch 1,
  D = 128): the loss and every gradient, fp32 through ``plain`` and bf16
  through ``fused`` (K1, K2, K6, K7 in the port; their plain versions on the
  CPU), held as ``tests/test_torch_train_step.py`` holds a step. JAX's fused
  training there dispatches its attention backward by
  ``pallas_block.attn_bwd_fits``: at these widths the Pallas kernel fits and
  runs in interpret mode (the test asserts that it is the path taken).

Tolerances: K10 and every output of K6 fp32 1e-5 and bf16 5e-2, the kernels'
tolerances of ``tests/test_torch_long_seq.py``, except K6's fp32 weight and
LayerNorm gradients, which sum 1,025 (or 290) rows of products in another
order than XLA's and are held as ``tests/test_torch_head_width.py`` holds
K6's fp32 gradients (rtol 2e-4, atol 2e-5); the train step's loss and
gradients as ``test_torch_train_step.py``: fp32 loss 1e-6 and gradients rtol
1e-4 / atol 1e-6, bf16 loss 1e-5 relative and gradients 5e-2 relative
Frobenius.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duodiff_tpu.config import UViTConfig as JaxConfig
from duodiff_tpu.diffusion.schedule import NoiseSchedule as JaxSchedule
from duodiff_tpu.models.uvit import init_uvit as jax_init_uvit
from duodiff_tpu.ops import pallas_attention as jax_fa
from duodiff_tpu.ops import pallas_block as pb
from duodiff_tpu.training.train_state import make_train_step as jax_make_train_step
from duodiff_tpu_torch.config import UViTConfig
from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
from duodiff_tpu_torch.models.uvit import UViT
from duodiff_tpu_torch.ops import block
from duodiff_tpu_torch.ops import flash_attention as fa
from duodiff_tpu_torch.training.train_state import make_train_step
from duodiff_tpu_torch.utils.convert import uvit_state_dict_from_jax

torch.set_num_threads(1)

HEADS = 2
WIDTHS = [64, 72]
LENGTHS = [290, 1025]
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"fp32": 1e-5, "bf16": 5e-2}
K6_NAMES = ("dx", "dg", "db", "dwqkv", "dbqkv", "dwp", "dbp")


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _np(t):
    return np.asarray(t.astype(jnp.float32)) if isinstance(t, jnp.ndarray) else t.float().numpy()


def _heads(l, dh, seed):
    rng = np.random.default_rng(seed + l + dh)
    return [rng.standard_normal((2, HEADS, l, dh)).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("l", LENGTHS)
@pytest.mark.parametrize("dh", WIDTHS)
@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_k10_plain_matches_pallas_past_272(dtype_name, dh, l):
    jdt, tdt = DTYPES[dtype_name]
    arrays = _heads(l, dh, seed=0)
    got = fa.flash_attention_bwd_plain(*[_t(a, tdt) for a in arrays])
    want = jax_fa._flash_attention_bwd_impl(*[jnp.asarray(a).astype(jdt) for a in arrays],
                                            interpret=True)
    tol = TOL[dtype_name]
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == tdt and g.shape == (2, HEADS, l, dh)
        np.testing.assert_allclose(_np(g), _np(w), rtol=tol, atol=tol, err_msg=name)


def _block_inputs(l, dh, seed):
    """numpy x, dy (1, l, D) and the attention sublayer's parameters in the
    JAX layout (kernels (in, out), the qkv kernel unscaled), D = 2 * dh."""
    d = HEADS * dh
    rng = np.random.RandomState(seed + l + dh)
    r = lambda *s: (0.05 * rng.randn(*s)).astype(np.float32)  # noqa: E731
    x = rng.randn(1, l, d).astype(np.float32)
    dy = rng.randn(1, l, d).astype(np.float32)
    p = {"ln_s": 1.0 + r(d), "ln_b": r(d), "wqkv": r(d, 3 * d), "bqkv": r(3 * d),
         "wp": r(d, d)}
    return x, dy, p


@pytest.mark.parametrize("l", LENGTHS)
@pytest.mark.parametrize("dh", WIDTHS)
@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_k6_plain_matches_pallas_past_272(dtype_name, dh, l):
    """With a qkv bias at head width 64 and without at 72, so that both
    forms of the dbqkv output are held."""
    x, dy, p = _block_inputs(l, dh, seed=1)
    bqkv = p["bqkv"] if dh == 64 else None
    jdt, tdt = DTYPES[dtype_name]
    want = pb._attn_sublayer_bwd_impl(jnp.asarray(x, jdt), jnp.asarray(dy, jdt), p["ln_s"],
                                      p["ln_b"], p["wqkv"], bqkv, p["wp"], num_heads=HEADS,
                                      eps=1e-5, interpret=True)
    before = block.fused_attn_sublayer_bwd.launches
    got = block.fused_attn_sublayer_bwd(_t(x, tdt), _t(dy, tdt), _t(p["ln_s"]), _t(p["ln_b"]),
                                        _t(p["wqkv"], tdt), _t(bqkv), _t(p["wp"], tdt),
                                        num_heads=HEADS)
    assert block.fused_attn_sublayer_bwd.launches == before  # the CPU: the plain version
    tol = TOL[dtype_name]
    for name, g, w in zip(K6_NAMES, got, want):
        if w is None:
            assert g is None, name
            continue
        assert g.shape == w.shape, name
        rtol, atol = (2e-4, 2e-5) if dtype_name == "fp32" and name != "dx" else (tol, tol)
        np.testing.assert_allclose(_np(g), _np(w), rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("l", LENGTHS)
def test_the_backward_measuring_entrys_plain_core_is_the_kernels(l):
    """attn_bwd_core_form's plain version, which the card holds both forms of
    the backward core to: K10's (dq, dk, dv), and with the forward output
    first K6's core, whose o is K9's."""
    q, k, v, do = (_t(a, torch.bfloat16) for a in _heads(l, 64, seed=2))
    want = fa.flash_attention_bwd_plain(q, k, v, do)
    got = fa.attn_bwd_core_form(q, k, v, do)
    assert len(got) == 3 and all(torch.equal(g, w) for g, w in zip(got, want))
    got = fa.attn_bwd_core_form(q, k, v, do, with_o=True)
    assert torch.equal(got[0], fa.flash_attention_plain(q, k, v))
    assert all(torch.equal(g, w) for g, w in zip(got[1:], want))


# --- one train step of a U-ViT at L = 1025 ----------------------------------------

LONG = dict(img_size=32, patch_size=1, in_chans=3, embed_dim=128, num_heads=HEADS, mlp_ratio=4,
            depth=3, qkv_bias=False, mlp_time_embed=False, num_classes=-1,
            normalize_timesteps=True)
IMAGES = (2, 32, 32, 3)


def _draws(key, shape):
    """JAX's own draws of a train step: (timesteps, noise) as torch tensors."""
    t_key, n_key = jax.random.split(key)
    t = np.asarray(jax.random.randint(t_key, (shape[0],), 0, 1000))
    noise = np.asarray(jax.random.normal(n_key, shape, jnp.float32))
    return torch.from_numpy(t).long(), torch.from_numpy(noise.copy())


def _jax_step(jdt, key):
    """JAX's loss and gradients of one train step of LONG's U-ViT, fused, in
    dtype jdt, on numpy-seeded weights and images; returns (params, images,
    loss, gradients as the port's state dict)."""
    jmodel, params = jax_init_uvit(JaxConfig(**LONG), jax.random.PRNGKey(0), dtype=jdt,
                                   attn_impl="fused")
    rng = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.02 * rng.randn(*a.shape).astype(np.float32), params)
    jstep = jax_make_train_step(lambda p, x, t, y: jmodel.apply({"params": p}, x, t, y),
                                JaxSchedule.create(steps=1000), model_kind="uvit",
                                parametrization="predict_noise")
    x = rng.uniform(-1, 1, IMAGES).astype(np.float32)
    batch = {"image": jnp.asarray(x), "label": jnp.zeros(IMAGES[0], jnp.int32)}
    (loss, _), grads = jax.value_and_grad(jstep.loss_fn, has_aux=True)(params, batch, key)
    return params, x, float(loss), uvit_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
def test_a_train_step_at_1025_tokens_matches_jax(dtype_name):
    """fp32: the loss within 1e-5 (a mean of 6,144 squared errors whose JAX
    value moves by ~2e-6 with the CPU client's reduction order) and every
    gradient at rtol 1e-4 / atol 1e-6, as test_torch_train_step.py. bf16:
    the loss within 1e-4 of JAX's, relative (bf16 outputs flipped by an ulp
    now and then by summation order), every gradient within 5e-2 (relative
    Frobenius, test_torch_train_step.py's bound) of the same step's fp32
    gradient, and all gradients together within 5e-2 of JAX's bf16 ones.
    Per parameter, JAX's own bf16 gradients are no closer to each other than
    that at this length: a bias summed over 2,048 tokens (final_layer.bias)
    lies 5.4e-2 from the fp32 gradient in JAX's bf16 and 1.5e-2 in the
    port's, so the port's are held to the fp32 step."""
    jdt, tdt, impl = {"fp32": (jnp.float32, torch.float32, "plain"),
                      "bf16": (jnp.bfloat16, torch.bfloat16, "fused")}[dtype_name]
    # JAX's fused backward runs the Pallas kernel (interpret mode) at these widths
    assert pb.attn_bwd_fits(IMAGES[0], 1025, LONG["embed_dim"], 2)
    key = jax.random.PRNGKey(5)
    params, x, loss, want = _jax_step(jdt, key)

    model = UViT(UViTConfig(**LONG), dtype=tdt, attn_impl=impl)
    assert model.config.num_patches + model.config.extras == 1025
    model.load_state_dict(uvit_state_dict_from_jax(params), strict=True)
    step = make_train_step(model, NoiseSchedule.create(steps=1000),
                           parametrization="predict_noise", seed=0)
    metrics, got = step.backward({"image": torch.from_numpy(x)}, *_draws(key, x.shape))
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(want)
    got = {n: g.float().numpy() for n, g in zip(names, got)}
    if dtype_name == "fp32":
        assert abs(metrics["train_loss"].item() - loss) <= 1e-5
        for name, g in got.items():
            np.testing.assert_allclose(g, want[name].numpy(), rtol=1e-4, atol=1e-6, err_msg=name)
        return
    assert abs(metrics["train_loss"].item() / loss - 1) <= 1e-4
    _, _, _, fp32 = _jax_step(jnp.float32, key)
    for name, g in got.items():
        assert _rel(g, fp32[name].numpy()) <= 5e-2, name
    flat = lambda d: np.concatenate([np.asarray(d[n]).ravel() for n in names])  # noqa: E731
    assert _rel(flat(got), flat({n: w.numpy() for n, w in want.items()})) <= 5e-2
