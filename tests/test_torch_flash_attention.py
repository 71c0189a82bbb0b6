"""The port's standalone attention (duodiff_tpu_torch.ops.flash_attention,
ops.attention) against the JAX package's Pallas kernels K9 and K10, run in
interpret mode on the CPU, on the same inputs made from a seed with numpy:
(B, H, L, Dh) = (2, 2, L, 64) with L = 18 (16 patches + 2 tokens) and the
ragged L = 66; and (1, 2, L, 64) at the lengths where the CUDA cores' 16-row
query tiles, 16-key steps and 272-key limit break (1, 63, 64, 65, 129, 257,
272), with the wrappers' refusal of L = 273.

On the CPU the wrappers take their plain PyTorch versions, which repeat
the kernels' arithmetic with the same rounding points. Tolerances are the
JAX tests' own between the package's attention paths (tests/test_ops.py):
fp32 1e-5 (summation order only); bf16 forward 5e-2 and backward 2e-2
(bf16 rounding at the same points, flipped now and then by summation
order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duodiff_tpu.ops import pallas_attention as jax_fa
from duodiff_tpu.ops.attention import xla_attention as jax_xla_attention
from duodiff_tpu_torch.ops import flash_attention as fa
from duodiff_tpu_torch.ops.attention import (
    ATTENTION_IMPLS,
    multi_head_attention,
    xla_attention,
)

torch.set_num_threads(1)

DTYPES = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
FWD_TOL = {"fp32": 1e-5, "bf16": 5e-2}
BWD_TOL = {"fp32": 1e-5, "bf16": 2e-2}
LENGTHS = [18, 66]


# fp32 at every length a tile or the limit breaks at, bf16 at two of them
RAGGED_CASES = ([("fp32", l) for l in (1, 63, 64, 65, 129, 257, 272)]
                + [("bf16", l) for l in (65, 257)])


def _inputs(l, n=4, seed=0, batch=2):
    rng = np.random.default_rng(seed + l)
    return [rng.standard_normal((batch, 2, l, 64)).astype(np.float32) for _ in range(n)]


def _torch(arrays, dtype):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _jax(arrays, dtype):
    return [jnp.asarray(a).astype(dtype) for a in arrays]


def _np(t):
    return np.asarray(t.astype(jnp.float32)) if isinstance(t, jnp.ndarray) else t.float().numpy()


@pytest.mark.parametrize("l", LENGTHS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_forward_matches_pallas_interpret(dtype, l):
    tdt, jdt = DTYPES[dtype]
    arrays = _inputs(l, 3)
    got = fa.flash_attention_plain(*_torch(arrays, tdt))
    want = jax_fa.flash_attention(*_jax(arrays, jdt), interpret=True)
    assert got.dtype == tdt and got.shape == (2, 2, l, 64)
    np.testing.assert_allclose(_np(got), _np(want), rtol=FWD_TOL[dtype], atol=FWD_TOL[dtype])


@pytest.mark.parametrize("l", LENGTHS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_xla_attention_matches_jax_and_the_plain_kernel(dtype, l):
    tdt, jdt = DTYPES[dtype]
    arrays = _inputs(l, 3, seed=1)
    got = xla_attention(*_torch(arrays, tdt))
    assert got.dtype == torch.float32
    want = jax_xla_attention(*_jax(arrays, jdt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    plain = fa.flash_attention_plain(*_torch(arrays, tdt))
    np.testing.assert_allclose(_np(plain), got.numpy(), rtol=FWD_TOL[dtype], atol=FWD_TOL[dtype])


@pytest.mark.parametrize("l", LENGTHS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_backward_matches_pallas_interpret(dtype, l):
    tdt, jdt = DTYPES[dtype]
    arrays = _inputs(l, 4, seed=2)
    got = fa.flash_attention_bwd_plain(*_torch(arrays, tdt))
    want = jax_fa._flash_attention_bwd_impl(*_jax(arrays, jdt), interpret=True)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == tdt
        np.testing.assert_allclose(_np(g), _np(w), rtol=BWD_TOL[dtype], atol=BWD_TOL[dtype],
                                   err_msg=name)


@pytest.mark.parametrize("dtype,l", RAGGED_CASES)
def test_plain_forward_matches_pallas_interpret_at_ragged_lengths(dtype, l):
    tdt, jdt = DTYPES[dtype]
    arrays = _inputs(l, 3, seed=7, batch=1)
    got = fa.flash_attention_plain(*_torch(arrays, tdt))
    want = jax_fa.flash_attention(*_jax(arrays, jdt), interpret=True)
    assert got.dtype == tdt and got.shape == (1, 2, l, 64)
    np.testing.assert_allclose(_np(got), _np(want), rtol=FWD_TOL[dtype], atol=FWD_TOL[dtype])


@pytest.mark.parametrize("dtype,l", RAGGED_CASES)
def test_plain_backward_matches_pallas_interpret_at_ragged_lengths(dtype, l):
    tdt, jdt = DTYPES[dtype]
    arrays = _inputs(l, 4, seed=8, batch=1)
    got = fa.flash_attention_bwd_plain(*_torch(arrays, tdt))
    want = jax_fa._flash_attention_bwd_impl(*_jax(arrays, jdt), interpret=True)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == tdt and g.shape == (1, 2, l, 64)
        np.testing.assert_allclose(_np(g), _np(w), rtol=BWD_TOL[dtype], atol=BWD_TOL[dtype],
                                   err_msg=name)


@pytest.mark.parametrize("l", LENGTHS)
def test_plain_backward_matches_autograd_in_fp32(l):
    """K10's plain version against autograd through K9's plain version and
    through plain attention: the same gradient for the unscaled q."""
    arrays = _inputs(l, 4, seed=3)
    do = torch.from_numpy(arrays[3])
    got = fa.flash_attention_bwd_plain(*_torch(arrays, torch.float32))
    for fn in (fa.flash_attention_plain, xla_attention):
        leaves = [t.requires_grad_() for t in _torch(arrays[:3], torch.float32)]
        want = torch.autograd.grad(fn(*leaves), leaves, do)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("impl", ["pallas", "pallas_plain"])
def test_autograd_function_runs_the_backward_version(impl):
    """multi_head_attention(impl="pallas") pairs K9 with K10: its gradients
    are flash_attention_bwd's to the bit, and it saves q, k and v only."""
    arrays = _inputs(18, 4, seed=4)
    leaves = [t.requires_grad_() for t in _torch(arrays[:3], torch.bfloat16)]
    do = torch.from_numpy(arrays[3]).to(torch.bfloat16)
    out = multi_head_attention(*leaves, impl=impl)
    assert out.dtype == torch.bfloat16
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 3 and all(s.shape == (2, 2, 18, 64) for s in saved)
    got = torch.autograd.grad(out, leaves, do)
    want = fa.flash_attention_bwd_plain(*[t.detach() for t in leaves], do)
    assert torch.equal(out, fa.flash_attention_plain(*[t.detach() for t in leaves]))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_dispatch_names_and_refusal():
    q, k, v = _torch(_inputs(18, 3, seed=5), torch.float32)
    assert set(ATTENTION_IMPLS) == {"auto", "xla", "pallas", "pallas_plain"}
    assert torch.equal(multi_head_attention(q, k, v, impl="auto"),
                       multi_head_attention(q, k, v, impl="xla"))
    with pytest.raises(ValueError, match="impl must be one of"):
        multi_head_attention(q, k, v, impl="fused")


def test_cpu_calls_launch_no_kernel():
    """The launch counters count kernel launches only: a CPU call, which
    takes the plain version, leaves them alone."""
    arrays = _torch(_inputs(18, 4, seed=6), torch.float32)
    before = fa.flash_attention.launches, fa.flash_attention_bwd.launches
    fa.flash_attention(*arrays[:3])
    fa.flash_attention_bwd(*arrays)
    assert (fa.flash_attention.launches, fa.flash_attention_bwd.launches) == before


@pytest.mark.parametrize("what", ["head_dim", "dtype", "rank", "shape"])
def test_kernel_operand_checks(what):
    """What the CUDA wrappers refuse, checked before any device is touched
    (the checks run on the tensors' metadata)."""
    q = torch.zeros(1, 2, 18, 64, dtype=torch.bfloat16)
    bad = {
        "head_dim": (q[..., :32], ValueError, "head width 64 or 72, got 32"),
        "dtype": (q.float(), TypeError, "bfloat16"),
        "rank": (q[0], ValueError, r"\(B, H, L, Dh\)"),
        "shape": (q, ValueError, "is on cpu"),
    }[what]
    with pytest.raises(bad[1], match=bad[2]):
        fa._dims(bad[0], {"q": bad[0]})


class _Limits:
    """Stands in for the loaded kernel library: it knows the cores' head
    widths and their longest sequence at each, and has no kernel entry, so a
    call that got past the length check would fail with AttributeError, not
    ValueError."""

    @staticmethod
    def duodiff_attn_head_width(i):
        return (64, 72)[i] if i < 2 else 0

    @staticmethod
    def duodiff_attn_core_max_len(dh):
        return 272 if dh in (64, 72) else 0

    @staticmethod
    def duodiff_attn_bwd_core_max_len(dh):
        return 272 if dh in (64, 72) else 0


@pytest.mark.parametrize("kernel", ["K9", "K10", "K1", "K6"])
def test_wrappers_refuse_a_sequence_the_cores_cannot_hold(kernel, monkeypatch):
    """The cores keep 16 whole score rows in a warp's registers, which bounds
    L at 272: each CUDA wrapper refuses L = 273 before it allocates or
    launches anything. The device checks are taken out so that CPU tensors
    reach the length check."""
    from duodiff_tpu_torch.ops import _build, block

    monkeypatch.setattr(_build, "load_library", lambda: _Limits)
    monkeypatch.setattr(block, "_check", lambda *a: None)
    monkeypatch.setattr(fa, "_check", lambda *a: None)
    bf = torch.bfloat16
    q = torch.zeros(1, 1, 273, 64, dtype=bf)
    x = torch.zeros(1, 273, 64, dtype=bf)
    vec, wqkv, wp = torch.zeros(64), torch.zeros(64, 192, dtype=bf), torch.zeros(64, 64, dtype=bf)
    call = {
        "K9": lambda: fa._flash_attention_cuda(q, q, q),
        "K10": lambda: fa._flash_attention_bwd_cuda(q, q, q, q),
        "K1": lambda: block._attn_sublayer_cuda(x, vec, vec, wqkv, None, wp, vec, num_heads=1,
                                                eps=1e-5, variant="v2"),
        "K6": lambda: block._attn_sublayer_bwd_cuda(x, x, vec, vec, wqkv, None, wp, num_heads=1,
                                                    eps=1e-5),
    }[kernel]
    with pytest.raises(ValueError, match="sequence length 273 does not fit the attention"):
        call()


def test_length_check_takes_the_limit_itself():
    from duodiff_tpu_torch.ops.block import _check_seq_len

    _check_seq_len(_Limits, 272, 64)
    _check_seq_len(_Limits, 272, 64, backward=True)
    with pytest.raises(ValueError, match="backward core"):
        _check_seq_len(_Limits, 273, 64, backward=True)
