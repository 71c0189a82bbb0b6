"""The port's training step (duodiff_tpu_torch.training) against the JAX
package's make_train_step on a small UViT (img 8, patch 2, D 64, depth 3)
with the same weights, batch, timesteps and noise: the test draws the
timesteps and noise from JAX's key split and injects them into the port.
The JAX model runs attn_impl="fused", so its gradients come from the
Pallas backward kernels K6 and K7 in interpret mode.

Tolerances, each with its reason:
- fp32 (port "plain", autograd through the plain sublayers): loss 1e-6,
  every gradient rtol 1e-4 / atol 1e-6, parameters and EMA after three
  clipped AdamW steps atol 2e-5 (measured 3e-6; lr 1e-3);
- bf16 (port "fused", the autograd Functions whose CPU backward is the
  plain K6 / K7): loss 1e-5 relative, each gradient 5e-2 relative
  Frobenius (bf16 rounding at the same points, flipped now and then by
  fp32 summation order; measured <= 2e-2);
- the optimizer, EMA and LR schedule alone against optax on identical
  gradients: rtol 1e-6, since Adam turns gradient noise near zero into
  whole-lr steps and so cannot be compared tightly through a model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from duodiff_tpu.config import UViTConfig as JaxConfig
from duodiff_tpu.diffusion.schedule import NoiseSchedule as JaxSchedule
from duodiff_tpu.models.uvit import init_uvit as jax_init_uvit
from duodiff_tpu.training.losses import uvit_loss as jax_uvit_loss
from duodiff_tpu.training.lr import cosine_schedule_with_warmup as jax_cosine
from duodiff_tpu.training.train_state import create_train_state
from duodiff_tpu.training.train_state import make_optimizer as jax_make_optimizer
from duodiff_tpu.training.train_state import make_train_step as jax_make_train_step
from duodiff_tpu_torch.config import UViTConfig
from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
from duodiff_tpu_torch.models.uvit import UViT
from duodiff_tpu_torch.training.losses import uvit_loss
from duodiff_tpu_torch.training.lr import cosine_schedule_with_warmup
from duodiff_tpu_torch.training.train_state import (
    TrainState,
    make_optimizer,
    make_train_step,
    step_generator,
)
from duodiff_tpu_torch.utils.convert import uvit_state_dict_from_jax

torch.set_num_threads(1)

SMALL = dict(img_size=8, patch_size=2, in_chans=3, embed_dim=64, num_heads=4, mlp_ratio=4,
             depth=3)
OPT = dict(lr=1e-3, weight_decay=0.03, beta1=0.9, beta2=0.999, max_grad_norm=0.05,
           num_warmup_steps=0, num_training_steps=10)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_setup(dtype, seed=0):
    model, params = jax_init_uvit(JaxConfig(**SMALL), jax.random.PRNGKey(seed), dtype=dtype,
                                  attn_impl="fused")
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.02 * rng.randn(*a.shape).astype(np.float32), params)
    step = jax_make_train_step(lambda p, x, t, y: model.apply({"params": p}, x, t, y),
                               JaxSchedule.create(steps=1000), model_kind="uvit",
                               parametrization="predict_noise")
    x = rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
    return params, step, x


def _draws(key, shape):
    """JAX's own draws of a train step: (timesteps, noise) as torch tensors."""
    t_key, n_key = jax.random.split(key)
    t = np.asarray(jax.random.randint(t_key, (shape[0],), 0, 1000))
    noise = np.asarray(jax.random.normal(n_key, shape, jnp.float32))
    return torch.from_numpy(t).long(), torch.from_numpy(noise.copy())


def _port(params, dtype, impl):
    model = UViT(UViTConfig(**SMALL), dtype=dtype, attn_impl=impl)
    model.load_state_dict(uvit_state_dict_from_jax(params), strict=True)
    step = make_train_step(model, NoiseSchedule.create(steps=1000),
                           parametrization="predict_noise", seed=0)
    return model, step


@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
def test_loss_and_every_gradient_match_jax(dtype_name):
    jdt, tdt, impl = {"fp32": (jnp.float32, torch.float32, "plain"),
                      "bf16": (jnp.bfloat16, torch.bfloat16, "fused")}[dtype_name]
    params, jstep, x = _jax_setup(jdt)
    key = jax.random.PRNGKey(5)
    batch = {"image": jnp.asarray(x), "label": jnp.zeros(2, jnp.int32)}
    (loss, _), grads = jax.value_and_grad(jstep.loss_fn, has_aux=True)(params, batch, key)
    want = uvit_state_dict_from_jax(_numpy_tree(grads))
    model, step = _port(params, tdt, impl)
    metrics, got = step.backward({"image": torch.from_numpy(x)}, *_draws(key, x.shape))
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(want)
    if dtype_name == "fp32":
        assert abs(metrics["train_loss"].item() - float(loss)) <= 1e-6
        for name, g in zip(names, got):
            np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=name)
    else:
        assert abs(metrics["train_loss"].item() / float(loss) - 1) <= 1e-5
        for name, g in zip(names, got):
            w = want[name].numpy()
            assert np.linalg.norm(g.numpy() - w) / np.linalg.norm(w) <= 5e-2, name


def test_clipped_adamw_steps_and_ema_match_jax():
    params, jstep, x = _jax_setup(jnp.float32, seed=1)
    model, step = _port(params, torch.float32, "plain")
    state = TrainState.create(model, make_optimizer(dict(model.named_parameters()), **OPT),
                              ema_decay=0.9)
    jstate = create_train_state(params, jax_make_optimizer(**OPT), ema_decay=0.9)
    jfn = jax.jit(jstep)
    batch = {"image": jnp.asarray(x), "label": jnp.zeros(2, jnp.int32)}
    base = jax.random.PRNGKey(3)
    for s in range(1, 4):
        key = jax.random.fold_in(base, s)
        jstate, jm = jfn(jstate, batch, key)
        m = step(state, {"image": torch.from_numpy(x)}, s, *_draws(key, x.shape))
        assert float(jm["grad_norm"]) > OPT["max_grad_norm"]  # clipping is active
        np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(m["train_loss"].item(), float(jm["train_loss"]), rtol=1e-5)
    want = uvit_state_dict_from_jax(_numpy_tree(jstate.params))
    want_ema = uvit_state_dict_from_jax(_numpy_tree(jstate.ema_params))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=2e-5, err_msg=name)
        np.testing.assert_allclose(state.ema[name].numpy(), want_ema[name].numpy(), atol=2e-5,
                                   err_msg=name)
    assert state.optimizer.count == 3


@pytest.mark.parametrize("max_grad_norm", [0.5, 100.0])
def test_optimizer_and_ema_match_optax(max_grad_norm):
    """Identical gradients through four updates (warmup then cosine), with
    and without clipping."""
    rng = np.random.RandomState(0)
    shapes = {"a": (5, 7), "b": (7,), "c": (3, 2, 2)}
    init = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    kw = dict(OPT, max_grad_norm=max_grad_norm, num_warmup_steps=2, num_training_steps=6)
    tx = jax_make_optimizer(**kw)
    jparams, jopt = dict(init), tx.init(init)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    model = torch.nn.Module()
    for k, v in tparams.items():
        model.register_parameter(k, v)
    state = TrainState.create(model, make_optimizer(tparams, **kw), ema_decay=0.5)
    jema = dict(init)
    for _ in range(4):
        grads = {k: rng.randn(*s).astype(np.float32) * 0.3 for k, s in shapes.items()}
        updates, jopt = tx.update(grads, jopt, jparams)
        jparams = optax.apply_updates(jparams, updates)
        jema = {k: jema[k] * 0.5 + np.asarray(jparams[k]) * 0.5 for k in shapes}
        norm = state.optimizer.step([torch.from_numpy(grads[k].copy()) for k in state.optimizer.names])
        state.update_ema()
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(grads)), rtol=1e-6)
    for k in shapes:
        np.testing.assert_allclose(tparams[k].detach().numpy(), np.asarray(jparams[k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(state.ema[k].numpy(), jema[k], rtol=1e-6, atol=1e-7)


def test_lr_schedule_matches_jax():
    jsched = jax_cosine(2e-4, 15, 100)
    sched = cosine_schedule_with_warmup(2e-4, 15, 100)
    for step in [0, 1, 7, 14, 15, 16, 50, 99, 100, 130]:
        np.testing.assert_allclose(sched(step), float(jsched(step)), rtol=1e-6, atol=1e-12)


def test_optimizer_state_round_trips_strictly():
    p = {"w": torch.nn.Parameter(torch.ones(3))}
    opt = make_optimizer(p, **OPT)
    opt.step([torch.ones(3)])
    other = make_optimizer({"w": torch.nn.Parameter(torch.ones(3))}, **OPT)
    other.load_state_dict(opt.state_dict())
    assert other.count == 1 and torch.equal(other.mu[0], opt.mu[0])
    with pytest.raises(KeyError):
        make_optimizer({"v": torch.nn.Parameter(torch.ones(3))}, **OPT).load_state_dict(
            opt.state_dict())


@pytest.mark.parametrize("parametrization",
                         ["predict_noise", "predict_original", "predict_previous"])
def test_uvit_loss_matches_jax(parametrization):
    rng = np.random.RandomState(0)
    clean, noise, pred = (rng.randn(3, 4, 4, 3).astype(np.float32) for _ in range(3))
    t = np.array([0, 500, 999])
    js, ts = JaxSchedule.create(steps=1000), NoiseSchedule.create(steps=1000)
    noisy_t = ts.add_noise(torch.from_numpy(clean), torch.from_numpy(t), torch.from_numpy(noise))
    ab = np.asarray(js.alphas_bar)[t][:, None, None, None]
    np.testing.assert_allclose(noisy_t.numpy(), np.sqrt(ab) * clean + np.sqrt(1 - ab) * noise,
                               rtol=1e-5, atol=1e-6)
    noisy = noisy_t.numpy()
    want = jax_uvit_loss(jnp.asarray(pred), parametrization=parametrization,
                         noise=jnp.asarray(noise), clean=jnp.asarray(clean),
                         noisy=jnp.asarray(noisy), timesteps=jnp.asarray(t), schedule=js)
    got = uvit_loss(torch.from_numpy(pred), parametrization=parametrization,
                    noise=torch.from_numpy(noise), clean=torch.from_numpy(clean),
                    noisy=noisy_t, timesteps=torch.from_numpy(t), schedule=ts)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def test_distillation_mixes_teacher_and_task():
    """alpha * MSE(student, teacher) + (1 - alpha) * task, the teacher run in
    eval mode under no grad, with the metrics the JAX step reports."""
    cfg = UViTConfig(**SMALL)
    student = UViT(cfg, dtype=torch.float32)
    teacher = UViT(cfg, dtype=torch.float32)
    teacher.pack_for_kernels()
    teacher.eval()
    step = make_train_step(student, NoiseSchedule.create(steps=1000),
                           parametrization="predict_noise", seed=0, teacher=teacher,
                           distill_alpha=0.25)
    x = torch.randn(2, 8, 8, 3, generator=torch.Generator().manual_seed(0))
    t, noise = step.draws({"image": x}, 1)
    loss, m = step.loss_fn({"image": x}, t, noise)
    assert set(m) == {"train_loss", "distill_loss", "task_loss"}
    np.testing.assert_allclose(loss.item(), 0.25 * m["distill_loss"].item()
                               + 0.75 * m["task_loss"].item(), rtol=1e-6)
    loss.backward()
    assert all(p.grad is None for p in teacher.parameters())


def test_draws_depend_only_on_seed_and_step():
    x = {"image": torch.zeros(4, 8, 8, 3)}
    step = make_train_step(UViT(UViTConfig(**SMALL)), NoiseSchedule.create(steps=1000),
                           parametrization="predict_noise", seed=7, t_min=300)
    t1, n1 = step.draws(x, 5)
    step.draws(x, 6)
    t2, n2 = step.draws(x, 5)
    assert torch.equal(t1, t2) and torch.equal(n1, n2)
    assert int(t1.min()) >= 300
    assert not torch.equal(n1, step.draws(x, 6)[1])
    g = step_generator(7, 5, "cpu")
    assert torch.equal(torch.randint(300, 1000, (4,), generator=g), t1)
