"""The port's bf16 convolutions and BN (dcgan_sr_tpu_torch/ops/nn.py,
compute_dtype=torch.bfloat16) against the JAX package's (ops/nn.py with
compute_dtype=jnp.bfloat16) on the CPU: the same numpy inputs, forward and
both gradients through the custom-VJP pair conv2d_cv / conv_transpose2d_cv
(the functions apply_network calls; tests/test_conv_vjp.py is their fp32
oracle), and BN's pooled, per-image and grouped statistics.

Tolerances.  Both sides round each product (fp32 accumulation of bf16
operands) to bf16 once, but sum in different orders, so an output may land
one bf16 step (2^-8 relative) away: rtol 2^-7 plus 1e-3 of the tensor's
largest magnitude.  A k4s2p1 dw is never rounded to bf16 on either side
(JAX's _dw_conv: bf16 operands, fp32 sums, fp32 out), so it is held at fp32
summation-order tolerance: rtol 1e-5 plus 1e-6 of its largest magnitude.
BN statistics are fp32 over the same bf16 tensor: 1e-6; its output one
bf16 step."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from dcgan_sr_tpu.ops import nn as JN
from dcgan_sr_tpu_torch.ops import nn as N

import torch_threads  # noqa: F401

BF = torch.bfloat16


def _rand(*shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(np.float32)


def _np(t):
    return np.asarray(jnp.asarray(t, jnp.float32)) if not isinstance(
        t, torch.Tensor) else t.detach().float().numpy()


def _close(got, want, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    tol = 2.0 ** -7 * np.abs(want) + 1e-3 * np.abs(want).max()
    bad = np.abs(got - want) > tol
    assert not bad.any(), (f"{what}: {bad.sum()} of {bad.size} off, max "
                           f"{np.abs(got - want).max():.3e}")


@pytest.mark.parametrize("transposed,ci,co,hw,k,s,p", [
    (True, 16, 8, 16, 4, 2, 1),      # the gray-3 bulge convT
    (True, 32, 16, 4, 4, 2, 1),      # the patch generator's layer 3
    (False, 8, 16, 32, 4, 2, 1),     # a k4s2p1 conv (custom dw)
    (False, 16, 8, 8, 3, 1, 0),      # patch-D valid conv (autodiff dw)
    (False, 32, 1, 4, 4, 1, 0),      # D head
])
def test_bf16_conv_forward_and_gradients_match_jax(transposed, ci, co, hw, k,
                                                   s, p):
    x = _rand(2, ci, hw, hw, seed=1)
    w = _rand(*((ci, co) if transposed else (co, ci)), k, k, seed=2,
              scale=0.2)
    jfn = JN.conv_transpose2d_cv if transposed else JN.conv2d_cv
    y, vjp = jax.vjp(lambda a, b: jfn(a, b, s, p, jnp.bfloat16),
                     jnp.asarray(x), jnp.asarray(w))
    assert y.dtype == jnp.bfloat16
    cot = _rand(*y.shape, seed=3)
    jdx, jdw = vjp(jnp.asarray(cot, jnp.bfloat16))

    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tfn = N.conv_transpose2d if transposed else N.conv2d
    ty = tfn(tx, tw, s, p, compute_dtype=BF)
    assert ty.dtype == BF
    ty.backward(torch.from_numpy(cot).to(BF))
    assert tx.grad.dtype == torch.float32 and tw.grad.dtype == torch.float32
    _close(ty, y, "y")
    _close(tx.grad, jdx, "dx")
    _close(tw.grad, jdw, "dw")
    dw = tw.grad.numpy()
    rounded = (dw == tw.grad.to(BF).float().numpy()).mean()
    if (k, s, p) == (4, 2, 1):       # fp32, as JAX's _dw_conv leaves it
        np.testing.assert_allclose(dw, _np(jdw), rtol=1e-5,
                                   atol=1e-6 * np.abs(dw).max())
        assert rounded < 0.5, rounded
    else:                            # autodiff of the bf16 conv: bf16 values
        assert rounded == 1.0, rounded


def test_bf16_conv_on_bf16_input_gives_bf16_gradients():
    """Inside a bf16 network x is already bf16: dx comes back in bf16 (the
    JAX VJP's dx.astype(x.dtype)), dw in the fp32 weight's dtype."""
    x = torch.from_numpy(_rand(1, 4, 8, 8)).to(BF).requires_grad_()
    w = torch.from_numpy(_rand(4, 8, 4, 4, seed=1)).requires_grad_()
    N.conv_transpose2d(x, w, 2, 1, compute_dtype=BF).float().sum().backward()
    assert x.grad.dtype == BF and w.grad.dtype == torch.float32


def _jax_bn(x, scale, bias, state=None):
    y, new = JN.batch_norm(x, scale, bias, state=state)
    return y, new


@pytest.mark.parametrize("mode", ["pooled", "per_image", "grouped", "running"])
def test_bf16_batch_norm_matches_jax(mode):
    n, c, groups = 6, 8, 3
    x = _rand(n, c, 5, 7, scale=2.0) + 0.5
    scale, bias = 1 + 0.1 * _rand(c, seed=1), 0.1 * _rand(c, seed=2)
    rm, rv = 0.1 * _rand(c, seed=3), 0.5 + np.abs(_rand(c, seed=4))
    jx = jnp.asarray(x, jnp.bfloat16)
    js, jb = jnp.asarray(scale), jnp.asarray(bias)
    jst = {"mean": jnp.asarray(rm), "var": jnp.asarray(rv)}
    if mode == "pooled":
        want, jnew = JN.batch_norm(jx, js, jb, state=jst)
    elif mode == "per_image":        # make_full_sr_fn's vmap of batch-of-one
        want = jax.vmap(lambda im: JN.batch_norm(im[None], js, jb)[0][0])(jx)
    elif mode == "grouped":          # the overlap pipeline's vmap over images
        want = jax.vmap(lambda g: JN.batch_norm(g, js, jb)[0])(
            jx.reshape(groups, n // groups, c, 5, 7)).reshape(jx.shape)
    else:
        want, _ = JN.batch_norm(jx, js, jb, state=jst, train=False)
    tx = torch.from_numpy(x).to(BF)
    ts, tb = torch.from_numpy(scale), torch.from_numpy(bias)
    tst = {"mean": torch.from_numpy(rm), "var": torch.from_numpy(rv)}
    got, new = N.batch_norm(
        tx, ts, tb, state=tst, train=mode != "running",
        per_image=mode == "per_image",
        groups=groups if mode == "grouped" else None)
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    g, w = _np(got), _np(want)
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
    assert (np.abs(g - w) <= step).all(), np.abs(g - w).max()
    assert (g == w).mean() > 0.99
    if mode == "pooled":             # running statistics stay fp32
        for k in ("mean", "var"):
            assert new[k].dtype == torch.float32
            np.testing.assert_allclose(new[k].numpy(), np.asarray(jnew[k]),
                                       rtol=1e-6, atol=1e-6)


def test_bf16_activations_round_as_xla_does():
    x = jnp.asarray(_rand(4096, scale=3.0), jnp.bfloat16)
    tx = torch.from_numpy(np.array(x.astype(jnp.float32))).to(BF)
    for jf, tf in ((lambda a: JN.leaky_relu(a, 0.2), N.leaky_relu),
                   (JN.sigmoid, N.sigmoid), (JN.tanh, N.tanh),
                   (JN.relu, N.relu)):
        np.testing.assert_array_equal(_np(tf(tx)), _np(jax.jit(jf)(x)))
