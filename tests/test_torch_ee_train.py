"""The port's early-exit training (DeeDiff) against the JAX package's: the
four-term loss, the loss parts and every parameter's gradient of one step on
injected timesteps and noise, the optimizer plain and with the backbone
frozen (``optax.multi_transform`` with ``set_to_zero``), also with gradient
accumulation and the skipping of non-finite updates, and a few steps through
the model with the backbone frozen. Also the heads' index-written LayerNorm
buffer and the per-timestep probes' gather, each against autograd through a
form without them, and activation checkpointing, which changes no bit.

Tolerances, each with its reason (fp32 throughout):
- the loss terms on the same inputs: 1e-6 relative (one reduction order);
- the loss parts and every gradient of a step through the model: rtol 1e-4,
  atol 1e-6 (``tests/test_torch_train_step.py``'s bound: XLA's and
  PyTorch's summation orders);
- the optimizer on identical gradients: rtol 1e-6 (as
  ``tests/test_torch_train_step.py``);
- three clipped AdamW steps through the model: atol 2e-5 (as
  ``tests/test_torch_train_step.py``: Adam turns gradient noise near zero
  into whole-lr steps); the frozen backbone bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from duodiff_tpu.config import UViTConfig as JaxConfig
from duodiff_tpu.diffusion.schedule import NoiseSchedule as JaxSchedule
from duodiff_tpu.models.early_exit import EarlyExitUViT as JaxEarlyExitUViT
from duodiff_tpu.training.losses import deediff_loss as jax_deediff_loss
from duodiff_tpu.training.losses import total_deediff_loss as jax_total_deediff_loss
from duodiff_tpu.training.train_state import create_train_state
from duodiff_tpu.training.train_state import make_optimizer as jax_make_optimizer
from duodiff_tpu.training.train_state import make_train_step as jax_make_train_step
from duodiff_tpu_torch.config import UViTConfig
from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
from duodiff_tpu_torch.models.early_exit import (
    CLASSIFIER_TYPES,
    EarlyExitUViT,
    TimestepProbeTable,
)
from duodiff_tpu_torch.models.layers import unpatchify
from duodiff_tpu_torch.training.losses import deediff_loss, total_deediff_loss
from duodiff_tpu_torch.training.train_state import TrainState, make_optimizer, make_train_step
from duodiff_tpu_torch.utils.convert import early_exit_state_dict_from_jax

torch.set_num_threads(1)

TINY = dict(img_size=16, patch_size=4, in_chans=3, embed_dim=32, depth=3, num_heads=4,
            mlp_ratio=4, num_classes=-1, normalize_timesteps=True)
SHAPE = (2, 16, 16, 3)
OPT = dict(lr=1e-3, weight_decay=0.03, beta1=0.9, beta2=0.999, max_grad_norm=0.05,
           num_warmup_steps=0, num_training_steps=10)


def _random_params(jmodel, cfg, seed):
    """JAX's parameter tree (shapes traced, nothing compiled) drawn from
    ``numpy.random.RandomState(seed)``: 0.05 N(0, 1), LayerNorm scales about
    1, no parameter zero."""
    x = jnp.zeros((1, cfg["img_size"], cfg["img_size"], cfg["in_chans"]), jnp.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), x, jnp.zeros((1,)))
                            )["params"]
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        value = 0.05 * rng.randn(*leaf.shape).astype(np.float32)
        return value + 1.0 if path[-1].key == "scale" else value

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _pair(kind, seed=0):
    """(JAX model, its params, the port's model on the same weights, config)."""
    cfg = dict(TINY, classifier_type=kind)
    jmodel = JaxEarlyExitUViT(config=JaxConfig(**cfg))
    params = _random_params(jmodel, cfg, seed)
    config = UViTConfig(**cfg)
    model = EarlyExitUViT(config, dtype=torch.float32, attn_impl="plain")
    model.load_state_dict(early_exit_state_dict_from_jax(params, config), strict=True)
    return jmodel, params, model.train(), config


def _draws(key, shape):
    """JAX's draws of a train step: (timesteps, noise) as torch tensors."""
    t_key, n_key = jax.random.split(key)
    t = np.array(jax.random.randint(t_key, (shape[0],), 0, 1000))
    noise = np.asarray(jax.random.normal(n_key, shape, jnp.float32))
    return torch.from_numpy(t).long(), torch.from_numpy(noise.copy())


def _image(seed):
    return np.random.RandomState(seed).uniform(-1, 1, SHAPE).astype(np.float32)


def _jax_step(jmodel, parametrization="predict_noise", use_unweighted_loss=False):
    return jax_make_train_step(lambda p, x, t, y: jmodel.apply({"params": p}, x, t, y),
                               JaxSchedule.create(steps=1000), model_kind="deediff_uvit",
                               parametrization=parametrization,
                               use_unweighted_loss=use_unweighted_loss)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# --- the loss ----------------------------------------------------------------


@pytest.mark.parametrize("use_unweighted_loss", [False, True])
@pytest.mark.parametrize("parametrization", ["predict_noise", "predict_original"])
def test_deediff_loss_matches_jax(parametrization, use_unweighted_loss):
    rng = np.random.RandomState(1)
    backbone, noise, clean = (rng.randn(3, 4, 4, 3).astype(np.float32) for _ in range(3))
    u = rng.uniform(0, 1, (5, 3)).astype(np.float32)
    g = rng.randn(5, 3, 4, 4, 3).astype(np.float32)
    want = jax_deediff_loss(jnp.asarray(backbone), jnp.asarray(u), jnp.asarray(g),
                            parametrization=parametrization, noise=jnp.asarray(noise),
                            clean=jnp.asarray(clean))
    got = deediff_loss(*map(torch.from_numpy, (backbone, u, g)), parametrization=parametrization,
                       noise=torch.from_numpy(noise), clean=torch.from_numpy(clean))
    assert len(got) == 4
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == ()
        np.testing.assert_allclose(a.item(), float(b), rtol=1e-6)
    np.testing.assert_allclose(total_deediff_loss(got, use_unweighted_loss).item(),
                               float(jax_total_deediff_loss(want, use_unweighted_loss)),
                               rtol=1e-6)


def test_deediff_loss_refuses_predict_previous():
    args = [torch.zeros(1, 2, 2, 3), torch.zeros(2, 1), torch.zeros(2, 1, 2, 2, 3)]
    with pytest.raises(ValueError, match="predict_previous"):
        deediff_loss(*args, parametrization="predict_previous", noise=args[0], clean=args[0])
    with pytest.raises(ValueError, match="predict_previous"):
        jax_deediff_loss(*map(jnp.asarray, args), parametrization="predict_previous",
                         noise=jnp.asarray(args[0]), clean=jnp.asarray(args[0]))


# --- one step through the model ------------------------------------------------


@pytest.mark.parametrize("kind", CLASSIFIER_TYPES)
def test_loss_parts_and_every_gradient_match_jax(kind):
    jmodel, params, model, config = _pair(kind, seed=CLASSIFIER_TYPES.index(kind))
    x = _image(2)
    key = jax.random.PRNGKey(7)
    batch = {"image": jnp.asarray(x), "label": jnp.zeros(2, jnp.int32)}
    (_, want), grads = jax.value_and_grad(_jax_step(jmodel).loss_fn, has_aux=True)(
        params, batch, key)
    want_grads = early_exit_state_dict_from_jax(_numpy_tree(grads), config)
    step = make_train_step(model, NoiseSchedule.create(steps=1000),
                           parametrization="predict_noise", seed=0, model_kind="deediff_uvit")
    metrics, got = step.backward({"image": torch.from_numpy(x)}, *_draws(key, x.shape))
    assert sorted(metrics) == sorted(want) == sorted(
        ["train_loss", "regular_train_loss", "classifier_train_loss", "weighted_train_loss",
         "unweighted_loss"])
    for name in want:
        np.testing.assert_allclose(metrics[name].item(), float(want[name]), rtol=1e-4,
                                   err_msg=name)
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(want_grads)
    for name, g in zip(names, got):
        np.testing.assert_allclose(g.numpy(), want_grads[name].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_unweighted_loss_is_added_to_the_total():
    _, _, model, _ = _pair("mlp_probe_per_layer")
    batch = {"image": torch.from_numpy(_image(3))}
    draws = _draws(jax.random.PRNGKey(1), SHAPE)
    losses = {}
    for flag in (False, True):
        step = make_train_step(model, NoiseSchedule.create(steps=1000),
                               parametrization="predict_noise", seed=0,
                               model_kind="deediff_uvit", use_unweighted_loss=flag)
        losses[flag] = {k: v.item() for k, v in step.loss_fn(batch, *draws)[1].items()}
    assert losses[True]["train_loss"] == pytest.approx(
        losses[False]["train_loss"] + losses[False]["unweighted_loss"], rel=1e-6)


def test_deediff_refuses_a_teacher():
    _, _, model, _ = _pair("mlp_probe_per_layer")
    with pytest.raises(ValueError, match="distillation"):
        make_train_step(model, NoiseSchedule.create(steps=1000), parametrization="predict_noise",
                        seed=0, model_kind="deediff_uvit", teacher=model)


# --- the heads' buffer and the tables' gather against plain autograd ----------------


def _heads_stacked(heads, hs, dtype):
    """OutputHeads.forward with the LayerNorms stacked instead of written into
    a buffer by index."""
    n, (b, l, d) = len(hs), hs[0].shape
    normed = torch.stack([F.layer_norm(h.float(), (d,), heads.norm_weight[i], heads.norm_bias[i],
                                       1e-5) for i, h in enumerate(hs)]).to(dtype)
    y = torch.matmul(normed.view(n, b * l, d), heads.decoder_weight.to(dtype).transpose(1, 2))
    y = y + heads.decoder_bias.to(dtype)[:, None]
    img = unpatchify(y.view(n * b, l, -1)[:, heads.extras:], heads.in_chans)
    c, hh, ww = heads.in_chans, img.shape[1], img.shape[2]
    img = img.view(n, b, hh, ww, c).permute(1, 0, 4, 2, 3).reshape(b, n * c, hh, ww)
    conv = F.conv2d(img, heads.conv_weight.to(dtype).reshape(n * c, c, 3, 3), padding=1,
                    groups=n)
    conv = conv + heads.conv_bias.to(dtype).reshape(n * c)[:, None, None]
    return conv.view(b, n, c, hh, ww).permute(1, 0, 3, 4, 2).float()


def _grads_of(fn, tensors):
    out = fn()
    w = torch.from_numpy(np.random.RandomState(4).randn(*out.shape).astype(np.float32))
    return out, torch.autograd.grad((out * w).sum(), tensors)


def test_heads_buffer_differentiates_as_a_stack():
    _, _, model, _ = _pair("mlp_probe_per_layer", seed=5)
    rng = np.random.RandomState(6)
    hs = [torch.from_numpy(rng.randn(2, 17, 32).astype(np.float32)).requires_grad_()
          for _ in range(3)]
    tensors = [*hs, *model.heads.parameters()]
    out, got = _grads_of(lambda: model.heads(hs, torch.float32), tensors)
    ref, want = _grads_of(lambda: _heads_stacked(model.heads, hs, torch.float32), tensors)
    assert torch.equal(out, ref)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("per_layer", [False, True])
def test_probe_table_gather_differentiates_as_a_one_hot_product(per_layer):
    torch.manual_seed(0)
    table = TimestepProbeTable(3, 8, per_layer=per_layer)
    with torch.no_grad():
        for p in table.parameters():
            p.normal_(0, 0.3)
    rng = np.random.RandomState(8)
    hs = [torch.from_numpy(rng.randn(4, 5, 8).astype(np.float32)).requires_grad_()
          for _ in range(3)]
    t_idx = torch.tensor([7, 999, 7, 0])  # a timestep twice: its row's gradients add

    def one_hot_form():
        onehot = F.one_hot(t_idx, 1000).float()
        out = []
        for s, h in enumerate(hs):
            w = table.weight[s] if per_layer else table.weight
            b = table.bias[s] if per_layer else table.bias
            logits = torch.einsum("bld,bd->bl", h, onehot @ w) + (onehot @ b)[:, None]
            out.append(torch.sigmoid(logits).mean(1))
        return torch.stack(out)

    tensors = [*hs, table.weight, table.bias]
    out, got = _grads_of(lambda: table(hs, t_idx, torch.float32), tensors)
    ref, want = _grads_of(one_hot_form, tensors)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), rtol=1e-6, atol=1e-7)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)


def test_use_checkpoint_changes_no_bit():
    _, _, model, config = _pair("attention_probe", seed=9)
    again = EarlyExitUViT(config, dtype=torch.float32, attn_impl="plain", use_checkpoint=True)
    again.load_state_dict(model.state_dict())
    batch = {"image": torch.from_numpy(_image(10))}
    draws = _draws(jax.random.PRNGKey(2), SHAPE)
    grads = [make_train_step(m.train(), NoiseSchedule.create(steps=1000),
                             parametrization="predict_noise", seed=0,
                             model_kind="deediff_uvit").backward(batch, *draws)[1]
             for m in (model, again)]
    for a, b in zip(*grads):
        assert torch.equal(a, b)


# --- the optimizer, plain and frozen ------------------------------------------------


SHAPES = {"uvit": {"a": (5, 7), "b": (7,)}, "heads": {"c": (3, 2, 2)}, "probes": {"d": (4,)}}


def _frozen_labels(params):
    """The JAX trainer's label function under --freeze_backbone."""
    return {k: jax.tree_util.tree_map(lambda _: "frozen" if k == "uvit" else "trainable", v)
            for k, v in params.items()}


def _flat(tree):
    return {f"{k}.{n}": np.asarray(v) for k, sub in tree.items() for n, v in sub.items()}


@pytest.mark.parametrize("option", ["plain", "frozen", "frozen_grad_accum", "frozen_skip"])
def test_optimizer_steps_match_optax(option):
    """Identical gradients through the port's update (``train_step.update``)
    and through optax, plain or inside ``multi_transform`` with
    ``set_to_zero`` on the backbone; the EMA over every parameter; the
    logged norm over every gradient. ``frozen_skip`` puts a NaN into a
    head's gradient at step 2 (the update is skipped) and into the
    backbone's at step 3 (it is not: the finite check sees the heads')."""
    frozen = option != "plain"
    kw = dict(OPT, max_grad_norm=0.5, num_warmup_steps=2, num_training_steps=6,
              grad_accum=2 if option == "frozen_grad_accum" else 1,
              skip_nonfinite=2 if option == "frozen_skip" else 0)
    rng = np.random.RandomState(0)
    init = {k: {n: rng.randn(*s).astype(np.float32) for n, s in sub.items()}
            for k, sub in SHAPES.items()}
    tx = jax_make_optimizer(**kw)
    if frozen:
        tx = optax.multi_transform({"trainable": tx, "frozen": optax.set_to_zero()},
                                   _frozen_labels)
    jparams, jopt = init, tx.init(init)
    jema = _flat(init)

    model = torch.nn.Module()
    for k, sub in init.items():
        mod = torch.nn.Module()
        for n, v in sub.items():
            mod.register_parameter(n, torch.nn.Parameter(torch.from_numpy(v.copy())))
        model.add_module(k, mod)
    names = [n for n, _ in model.named_parameters()]
    trainable = {n: p for n, p in model.named_parameters()
                 if not (frozen and n.startswith("uvit."))}
    state = TrainState.create(model, make_optimizer(trainable, **kw), ema_decay=0.5)
    step = make_train_step(model, NoiseSchedule.create(steps=10),
                           parametrization="predict_noise", seed=0)
    for s in range(1, 5):
        grads = {k: {n: rng.randn(*v.shape).astype(np.float32) * 0.3 for n, v in sub.items()}
                 for k, sub in init.items()}
        if option == "frozen_skip" and s == 2:
            grads["heads"]["c"][0, 0, 0] = np.nan
        if option == "frozen_skip" and s == 3:
            grads["uvit"]["a"][1, 2] = np.nan
        updates, jopt = tx.update(grads, jopt, jparams)
        jparams = optax.apply_updates(jparams, updates)
        jema = {n: jema[n] * 0.5 + v * 0.5 for n, v in _flat(jparams).items()}
        flat = _flat(grads)
        norm = step.update(state, [torch.from_numpy(flat[n].copy()) for n in names])
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(grads)), rtol=1e-6)
    want = _flat(jparams)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=1e-6, atol=1e-7, err_msg=n)
        np.testing.assert_allclose(state.ema[n].numpy(), jema[n], rtol=1e-6, atol=1e-7,
                                   err_msg=n)
        if frozen and n.startswith("uvit."):
            assert np.array_equal(p.detach().numpy(), _flat(init)[n])
    assert set(state.optimizer.names) == set(trainable)


def test_frozen_train_steps_match_jax():
    """Three steps through the model with the backbone frozen, against the
    JAX train step with the trainer's multi_transform: the backbone bit for
    bit what it was, the heads and probes as JAX moved them, the logged
    grad_norm JAX's (the norm over every gradient, the backbone's too)."""
    jmodel, params, model, config = _pair("mlp_probe_per_layer", seed=11)
    tx = optax.multi_transform({"trainable": jax_make_optimizer(**OPT),
                                "frozen": optax.set_to_zero()}, _frozen_labels)
    jstate = create_train_state(params, tx, ema_decay=0.9)
    jfn = jax.jit(_jax_step(jmodel))
    trainable = {n: p for n, p in model.named_parameters() if not n.startswith("uvit.")}
    state = TrainState.create(model, make_optimizer(trainable, **OPT), ema_decay=0.9)
    step = make_train_step(model, NoiseSchedule.create(steps=1000),
                           parametrization="predict_noise", seed=0, model_kind="deediff_uvit")
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    x = _image(12)
    batch = {"image": jnp.asarray(x), "label": jnp.zeros(2, jnp.int32)}
    base = jax.random.PRNGKey(3)
    for s in range(1, 4):
        key = jax.random.fold_in(base, s)
        jstate, jm = jfn(jstate, batch, key)
        m = step(state, {"image": torch.from_numpy(x)}, s, *_draws(key, x.shape))
        np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(m["train_loss"].item(), float(jm["train_loss"]), rtol=1e-5)
    want = early_exit_state_dict_from_jax(_numpy_tree(jstate.params), config)
    want_ema = early_exit_state_dict_from_jax(_numpy_tree(jstate.ema_params), config)
    for name, p in model.named_parameters():
        if name.startswith("uvit."):
            assert torch.equal(p.detach(), start[name]), name
        else:
            assert not torch.equal(p.detach(), start[name]), name
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=2e-5,
                                   err_msg=name)
        np.testing.assert_allclose(state.ema[name].numpy(), want_ema[name].numpy(), atol=2e-5,
                                   err_msg=name)
    assert state.optimizer.count == 3
