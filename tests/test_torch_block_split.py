"""The port's split MLP backward K8
(duodiff_tpu_torch.ops.block.fused_mlp_sublayer_bwd_split) on CPU tensors,
where it runs its plain PyTorch version, against the Pallas
_mlp_sublayer_bwd_split of duodiff_tpu/ops/pallas_block.py run with
interpret=True on the same numpy inputs; against the monolithic plain
backward; the order of the card's kernel (row chunks, each over the whole
hidden width), mirrored here in plain PyTorch, against both; and its
dispatch by DUODIFF_MLP_BWD_SPLIT.

Tolerances: fp32 rtol 1e-5 / atol 1e-5 per output, the bound
tests/test_ops.py holds the Pallas split kernel to against the monolithic
one (the sides differ in fp32 summation order only: slices, chunks or
neither); bf16 1 % relative Frobenius per output (the same roundings to
bf16, flipped now and then by that order) and dx elementwise within
5e-2 + 5e-2 * |want|."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duodiff_tpu.ops.pallas_block import _mlp_sublayer_bwd_split
from duodiff_tpu_torch.ops import block

torch.set_num_threads(1)

B, L, D, HID = 3, 33, 64, 256
NAMES = ("dx", "dg", "db", "dw1", "db1", "dw2", "db2")
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed=0, length=L):
    rng = np.random.RandomState(seed)
    r = lambda *s: (0.05 * rng.randn(*s)).astype(np.float32)  # noqa: E731
    x = rng.randn(B, length, D).astype(np.float32)
    dy = rng.randn(B, length, D).astype(np.float32)
    return x, dy, {"ln_s": 1.0 + r(D), "ln_b": r(D), "w1": r(D, HID), "b1": r(HID),
                   "w2": r(HID, D)}


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _operands(x, dy, p, tdt):
    return (_t(x, tdt), _t(dy, tdt), _t(p["ln_s"]), _t(p["ln_b"]), _t(p["w1"], tdt), _t(p["b1"]),
            _t(p["w2"], tdt))


def _compare(got, want, dtype_name, rtol=1e-5, atol=1e-5):
    for name, g, w in zip(NAMES, got, want):
        g = g.float().numpy()
        w = w.float().numpy() if isinstance(w, torch.Tensor) else np.asarray(w, np.float32)
        assert g.shape == w.shape, name
        if dtype_name == "fp32":
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=name)
            continue
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel <= 1e-2, (name, rel)
        if name == "dx":
            np.testing.assert_allclose(g, w, rtol=5e-2, atol=5e-2, err_msg=name)


@pytest.mark.parametrize("splits", [2, 4])
@pytest.mark.parametrize("gelu_approx", [False, True], ids=["erf", "tanh"])
@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
def test_split_bwd_matches_pallas(splits, gelu_approx, dtype_name):
    x, dy, p = _inputs()
    jdt, tdt = DTYPES[dtype_name]
    want = _mlp_sublayer_bwd_split(jnp.asarray(x, jdt), jnp.asarray(dy, jdt), p["ln_s"], p["ln_b"],
                                   p["w1"], p["b1"], p["w2"], eps=1e-5, gelu_approx=gelu_approx,
                                   interpret=True, config=(splits, 16, 64))
    before = block.fused_mlp_sublayer_bwd_split.launches
    got = block.fused_mlp_sublayer_bwd_split(*_operands(x, dy, p, tdt), splits=splits,
                                             gelu_approx=gelu_approx)
    assert block.fused_mlp_sublayer_bwd_split.launches == before  # no kernel on the CPU
    assert got[0].dtype == tdt and all(g.dtype == torch.float32 for g in got[1:])
    _compare(got, want, dtype_name)


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
def test_split_plain_matches_monolithic_plain(splits, dtype_name):
    """The slices only reorder fp32 sums: every rounding to bf16 happens on
    the same values as in the monolithic backward."""
    x, dy, p = _inputs(seed=1)
    ops = _operands(x, dy, p, DTYPES[dtype_name][1])
    want = block.mlp_sublayer_bwd_plain(*ops, gelu_approx=True)
    got = block.mlp_sublayer_bwd_split_plain(*ops, splits=splits, gelu_approx=True)
    _compare(got, want, dtype_name)
    assert torch.equal(got[6], want[6])  # db2 does not depend on the slices


def _row_chunk_order(x, dy, ln_s, ln_b, w1, b1, w2, *, splits, tile, gelu_approx, eps=1e-5):
    """The card's order of K8 (csrc/mlp_sublayer_bwd_split.cu) in plain fp32
    PyTorch: the rows cut into chunks of whole `tile`-row tiles (the row
    tiles over `splits`, rounded up; the last chunk takes what is left), each
    chunk through the whole hidden width: LayerNorm, h_pre, gelu and
    dh * gelu', dxn = dhp W1^T in one product over all hidden columns (no
    slice partials) and the LayerNorm backward at once; dW1, dW2, db1, dgamma
    and dbeta summed over the chunks in order, db2 over all of dy."""
    xs, dys = block._rows(x).float(), block._rows(dy).float()
    w1f, w2f, gamma = w1.float(), w2.float(), ln_s.float()
    m = xs.shape[0]
    chunk = -(-(-(-m // tile)) // splits) * tile
    dx, dw1, dw2, db1, dg, db = [], 0.0, 0.0, 0.0, 0.0, 0.0
    for r0 in range(0, m, chunk):
        xc, dyc = xs[r0:r0 + chunk], dys[r0:r0 + chunk]
        x_hat, rstd, xn = block._ln_fwd(xc, gamma, ln_b.float(), eps)
        h_pre = xn @ w1f + b1.float()
        hg = torch.nn.functional.gelu(h_pre, approximate="tanh" if gelu_approx else "none")
        dhp = (dyc @ w2f.t()) * block.gelu_grad(h_pre, gelu_approx)
        dxn = dhp @ w1f.t()
        dx.append(block._ln_bwd_dx(dxn, x_hat, rstd, gamma) + dyc)
        dw1, dw2 = dw1 + xn.t() @ dhp, dw2 + hg.t() @ dyc
        db1, dg, db = db1 + dhp.sum(0), dg + (dxn * x_hat).sum(0), db + dxn.sum(0)
    return (torch.cat(dx).reshape(x.shape), dg, db, dw1, db1, dw2, dys.sum(0))


@pytest.mark.parametrize("splits", [2, 4])
@pytest.mark.parametrize("gelu_approx", [False, True], ids=["erf", "tanh"])
@pytest.mark.parametrize("tile", [128, 16])
def test_row_chunk_order_matches_plain_and_pallas(splits, gelu_approx, tile):
    """K8's order on the card keeps the function: at 129 rows (3 x 43) the
    chunks of whole 128-row tiles are 128 rows and a ragged last one of 1,
    and with 16-row tiles 80 + 49 (2 splits) or 48 + 48 + 33 (4 splits); in
    fp32 the mirror meets the slice-by-slice plain version and the Pallas
    kernel (interpret mode) within the fp32 bound above."""
    x, dy, p = _inputs(seed=3, length=43)
    ops = _operands(x, dy, p, torch.float32)
    got = _row_chunk_order(*ops, splits=splits, tile=tile, gelu_approx=gelu_approx)
    plain = block.mlp_sublayer_bwd_split_plain(*ops, splits=splits, gelu_approx=gelu_approx)
    _compare(got, plain, "fp32")
    want = _mlp_sublayer_bwd_split(jnp.asarray(x), jnp.asarray(dy), p["ln_s"], p["ln_b"],
                                   p["w1"], p["b1"], p["w2"], eps=1e-5, gelu_approx=gelu_approx,
                                   interpret=True, config=(splits, 16, 64))
    _compare(got, want, "fp32")


def test_kernel_cuts_the_rows_not_the_hidden_width():
    """csrc/mlp_sublayer_bwd_split.cu runs K7's sequence on row chunks over
    the whole hidden width: one dxn product over all hidden columns a chunk
    (no fp32 dxn read back and added to), both weight gradients of a chunk in
    one launch that adds to the chunks before, no slice of w1 or w2."""
    src = (Path(block.__file__).resolve().parents[1] / "csrc/mlp_sublayer_bwd_split.cu").read_text()
    assert "chunk_rows(" in src and "launch_weight_grad_pair(" in src
    assert "launch_gemm_nt(dhp, Hd, w1b, Hd, dxn, rows, D, Hd" in src
    assert "launch_gemm_nt_accumulate" not in src and "w1s" not in src and "w2s" not in src


@pytest.mark.parametrize("splits", [0, 3, 64])
def test_splits_that_do_not_fit_are_refused(splits):
    """3 does not divide 256; 64 leaves slices of 4 columns, no 16-byte row."""
    x, dy, p = _inputs()
    with pytest.raises(ValueError, match="splits must divide"):
        block.fused_mlp_sublayer_bwd_split(*_operands(x, dy, p, torch.float32), splits=splits)


def test_split_launcher_refuses_cpu_tensors():
    x, dy, p = _inputs()
    with pytest.raises(ValueError, match="CUDA"):
        block._mlp_sublayer_bwd_split_cuda(*_operands(x, dy, p, torch.bfloat16), splits=2,
                                           gelu_approx=False, eps=1e-5)


@pytest.mark.parametrize("cfg, hidden, want", [
    (None, 256, 4), (None, 3072, 4), (None, 2048, 4), (None, 48, 2), ("8,128,256", 3072, 8),
    ("2", 256, 2), ("5,1,1", 256, 4), ("1,1,1", 256, 4),
])
def test_split_config(monkeypatch, cfg, hidden, want):
    """4, then 8, then 2 slices; DUODIFF_MLP_BWD_SPLIT_CFG overrides with its
    first field when that divides the hidden width, else it is passed over."""
    if cfg is None:
        monkeypatch.delenv("DUODIFF_MLP_BWD_SPLIT_CFG", raising=False)
    else:
        monkeypatch.setenv("DUODIFF_MLP_BWD_SPLIT_CFG", cfg)
    assert block.mlp_bwd_split_config(hidden) == want


@pytest.mark.parametrize("env, splits", [(None, None), ("0", None), ("1", 4)])
def test_dispatch_follows_the_environment(monkeypatch, env, splits):
    """FusedMlpSublayerFn's backward reads DUODIFF_MLP_BWD_SPLIT at call time:
    "1" takes the split backward, anything else the monolithic one."""
    monkeypatch.delenv("DUODIFF_MLP_BWD_SPLIT_CFG", raising=False)
    if env is None:
        monkeypatch.delenv("DUODIFF_MLP_BWD_SPLIT", raising=False)
    else:
        monkeypatch.setenv("DUODIFF_MLP_BWD_SPLIT", env)
    calls = []
    for name in ("fused_mlp_sublayer_bwd", "fused_mlp_sublayer_bwd_split"):
        fn = getattr(block, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            calls.append((_name, kw.get("splits")))
            return _fn(*a, **kw)

        monkeypatch.setattr(block, name, spy)
    x, dy, p = _inputs(seed=2)
    xt = _t(x, torch.bfloat16).requires_grad_(True)
    params = [torch.nn.Parameter(t) for t in (_t(p["ln_s"]), _t(p["ln_b"]), _t(p["w1"].T),
                                              _t(p["b1"]), _t(p["w2"].T), torch.zeros(D))]
    block.FusedMlpSublayerFn.apply(xt, *params, False, 1e-5).backward(_t(dy, torch.bfloat16))
    want_name = "fused_mlp_sublayer_bwd_split" if splits else "fused_mlp_sublayer_bwd"
    assert calls == [(want_name, splits)]
    want = block.mlp_sublayer_bwd_plain(*_operands(x, dy, p, torch.bfloat16))
    _compare((xt.grad, params[0].grad, params[1].grad, params[2].grad.t(), params[3].grad,
              params[4].grad.t(), params[5].grad), want, "bf16")
