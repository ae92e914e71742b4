"""The bulge pair in bf16 (dcgan_sr_tpu_torch/ops/bulge.py, bulge_mma.py) on
the CPU.  The plain bf16 version, which the wrapper runs on a CPU tensor and
which the CUDA kernel's bf16 instantiation is held to on the card, against
the JAX package's fused_bulge_fwd with bf16 x in interpret mode (Pallas's
own kernel, pallas_bulge.py), at the two path triples; at a ragged shape,
which that kernel does not take (W % 128, H % tm), against the JAX
package's ops/nn.py composition with the same rounding points.  Then the
packed version (the kernel's operands and rounding points, item by item)
against the plain one, the m16n8k16 fragment order, and the checks that
keep bf16 off the FMA kernel.

Tolerances.  Statistics are fp32 sums of the same fp32 hidden tensor in
another order: 1e-5 relative.  y is bf16: within one bf16 step of max|y|
(2^(floor(log2 max|y|) - 7)), the hidden tensor's rounding to bf16 and the
fp32 sums in another order being the only differences; the share of
elements that differ at all is printed and bounded by 1%."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from dcgan_sr_tpu.ops import nn as JN
from dcgan_sr_tpu.ops import pallas_bulge as JB
from dcgan_sr_tpu_torch import ablation
from dcgan_sr_tpu_torch.ops import bulge as K
from dcgan_sr_tpu_torch.ops import bulge_mma as M

from test_torch_bulge import _inputs

BF = torch.bfloat16


def _tensors(a, bf16_x=True):
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    if bf16_x:
        t["x"] = t["x"].to(BF)
    return t


def _ulp_of_max(y):
    return 2.0 ** (np.floor(np.log2(np.abs(y).max())) - 7)


def _hold_y(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    d = np.abs(got - want)
    share = float((d > 0).mean())
    print(f"{what}: max|dy| {d.max():.3e}, one step of max|y| "
          f"{_ulp_of_max(want):.3e}, {share:.4%} of elements differ")
    assert d.max() <= _ulp_of_max(want), what
    assert share <= 0.01, what


def _plain(t, stats="pooled", groups=None):
    y, (m, v) = K.bulge(t["x"], t["wT"], t["scale"], t["bias"], t["wC"],
                        stats=stats, groups=groups,
                        running=(t["rmean"], t["rvar"]) if stats == "running"
                        else None)
    assert y.dtype == BF and m.dtype == torch.float32
    return y.float().numpy(), m.numpy(), v.numpy()


@pytest.mark.parametrize("geom", [(2, 16, 8, 16, 32, 128),    # gray-3 triple
                                  (2, 32, 16, 32, 16, 128)])  # patch triple
def test_plain_bf16_pair_matches_jax_kernel(geom):
    a = _inputs(*geom, seed=3)
    x = jnp.asarray(a["x"], jnp.bfloat16)
    y, (m, v) = JB.fused_bulge_fwd(
        x, jnp.asarray(a["wT"]), jnp.asarray(a["scale"]),
        jnp.asarray(a["bias"]), jnp.asarray(a["wC"]), tm=16, interpret=True)
    assert y.dtype == jnp.bfloat16
    gy, gm, gv = _plain(_tensors(a))
    np.testing.assert_allclose(gm, np.asarray(m), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gv, np.asarray(v), rtol=1e-5, atol=1e-6)
    _hold_y(gy, np.asarray(y.astype(jnp.float32)), f"plain vs JAX K2 {geom}")


def _jax_composition(a, stats):
    """JAX ops/nn.py with the kernel's rounding points: bf16 x and weights,
    fp32 products (HIGHEST), fp32 statistics and BN, h rounded to bf16."""
    r = lambda k: jnp.asarray(a[k]).astype(jnp.bfloat16).astype(jnp.float32)  # noqa: E731
    h = JN.conv_transpose2d(r("x"), r("wT"), 2, 1)
    if stats == "running":
        mean, var = jnp.asarray(a["rmean"]), jnp.asarray(a["rvar"])
        hn = (h - mean[None, :, None, None]) * (
            jax.lax.rsqrt(var + 1e-5) * a["scale"])[None, :, None, None] \
            + a["bias"][None, :, None, None]
    else:
        axes = (2, 3) if stats == "per_image" else (0, 2, 3)
        mean = h.mean(axes, keepdims=True)
        var = (h * h).mean(axes, keepdims=True) - mean * mean
        sh = (1, -1, 1, 1)
        hn = (h - mean) * (jax.lax.rsqrt(var + 1e-5)
                           * a["scale"].reshape(sh)) + a["bias"].reshape(sh)
    hr = JN.relu(hn).astype(jnp.bfloat16).astype(jnp.float32)
    y = JN.conv2d(hr, r("wC"), 2, 1).astype(jnp.bfloat16)
    return np.asarray(y.astype(jnp.float32))


@pytest.mark.parametrize("stats", K.STATS_MODES)
@pytest.mark.parametrize("geom", [(2, 16, 8, 16, 37, 45),    # ragged
                                  (1, 8, 4, 8, 9, 5)])       # padded Cm 4
def test_plain_bf16_pair_matches_jax_composition(geom, stats):
    a = _inputs(*geom, seed=4)
    gy, _, _ = _plain(_tensors(a), stats)
    _hold_y(gy, _jax_composition(a, stats), f"{geom} {stats}")


@pytest.mark.parametrize("stats", K.STATS_MODES)
@pytest.mark.parametrize("geom", [(2, 16, 8, 16, 12, 20), (1, 32, 16, 32, 16, 33),
                                  (2, 8, 4, 8, 9, 5)])
def test_packed_bf16_pair_matches_plain(geom, stats):
    t = _tensors(_inputs(*geom, seed=5))
    run = (t["rmean"], t["rvar"]) if stats == "running" else None
    y, (m, v) = M.bulge_packed(t["x"], t["wT"], t["scale"], t["bias"],
                               t["wC"], stats=stats, running=run)
    assert y.dtype == BF
    py, pm, pv = _plain(t, stats)
    np.testing.assert_allclose(m.numpy(), pm, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(v.numpy(), pv, rtol=1e-5, atol=1e-6)
    _hold_y(y.float().numpy(), py, f"packed {geom} {stats}")


def test_packed_bf16_pair_with_grouped_statistics():
    t = _tensors(_inputs(4, 32, 16, 32, 8, 8, seed=6))
    y, (m, _) = M.bulge_packed(t["x"], t["wT"], t["scale"], t["bias"],
                               t["wC"], groups=2)
    py, pm, _ = _plain(t, "pooled", groups=2)
    assert m.shape == (2, 16)
    np.testing.assert_allclose(m.numpy(), pm, rtol=1e-5, atol=1e-6)
    _hold_y(y.float().numpy(), py, "packed grouped")


def test_bf16_fragment_order_is_what_an_mma_lane_reads():
    """Lane g*4 + t of mma.m16n8k16 holds B[k0 + 2t + i][n0 + g] in register
    0 and B[k0 + 8 + 2t + i][n0 + g] in register 1 (i = 0 in the lower
    half); the kernel reads both as one 8-byte word at
    ((ks*NT + nt)*32 + lane)*4."""
    k, n = 48, 24
    mat = np.arange(k * n).reshape(k, n)
    frag = M.to_fragments_bf16(mat)
    assert sorted(frag) == sorted(mat.reshape(-1))
    nt_n = n // 8
    for ks in range(k // 16):
        for nt in range(nt_n):
            for lane in range(32):
                g, t = lane // 4, lane % 4
                base = ((ks * nt_n + nt) * 32 + lane) * 4
                want = [mat[ks * 16 + 8 * j + 2 * t + i, nt * 8 + g]
                        for j in range(2) for i in range(2)]
                assert list(frag[base:base + 4]) == want


@pytest.mark.parametrize("kind", ["wT", "wC"])
@pytest.mark.parametrize("ci,cm,co", M.MMA_TRIPLES)
def test_bf16_operands_unpack_to_the_jax_packers(kind, ci, cm, co):
    """The bf16 operand, unpacked from fragment order, is W1 (W2) rounded to
    bf16, and W1's entries are those of the JAX package's pack_wT (W2's of
    pack_wC): every (tap, channel) weight lands where the kernel reads it."""
    rng = np.random.RandomState(ci)
    w = torch.from_numpy(rng.randn(*((ci, cm) if kind == "wT" else (co, cm)),
                                   4, 4).astype(np.float32))
    op = M.packed_operand(kind, w, BF)
    assert op.dtype == BF
    dense = M.pack_wT(w) if kind == "wT" else M.pack_wC(w)
    idx = M.to_fragments_bf16(np.arange(dense.numel()).reshape(dense.shape))
    unpacked = torch.empty(dense.numel(), dtype=BF)
    unpacked[torch.from_numpy(np.ascontiguousarray(idx))] = op
    assert torch.equal(unpacked.reshape(dense.shape), dense.to(BF))
    jw = jnp.asarray(w.numpy())
    cmp_ = M.padded_cm(cm)
    if kind == "wT":       # JAX rows (di,dj,cm), cols (ti,tjp,ci), tjp = tj + dj
        jp = np.asarray(JB.pack_wT(jw)).reshape(2, 2, cm, 2, 3, ci)
        mine = dense.numpy().reshape(2, 2, ci, 2, 2, cmp_)
        for ti in range(2):
            for tj in range(2):
                for di in range(2):
                    for dj in range(2):
                        np.testing.assert_array_equal(
                            mine[ti, tj, :, di, dj, :cm],
                            jp[di, dj, :, ti, tj + dj, :].T)
    else:                  # JAX (Co, 16 Cm), column block a*4 + c
        jp = np.asarray(JB.pack_wC(jw)).reshape(co, 4, 4, cm)
        mine = dense.numpy().reshape(4, 4, cmp_, co)
        for a_ in range(4):
            for c in range(4):
                np.testing.assert_array_equal(mine[a_, c, :cm],
                                              jp[:, a_, c, :].T)


def test_bf16_takes_the_tensor_core_kernel_or_raises():
    t = _tensors(_inputs(1, 16, 8, 16, 8, 8))
    assert K._impl_for(None, t["x"], t["wT"], t["wC"]) == "wgmma"
    t13 = _tensors(_inputs(1, 16, 8, 16, 8, 13))     # W % 8 != 0
    assert K._impl_for(None, t13["x"], t13["wT"], t13["wC"]) == "mma"
    with pytest.raises(ValueError, match="float32 only"):
        K._impl_for("fma", t["x"], t["wT"], t["wC"])
    odd = _tensors(_inputs(1, 5, 4, 8, 8, 8))
    with pytest.raises(ValueError, match="no bf16 instantiation"):
        K._impl_for(None, odd["x"], odd["wT"], odd["wC"])
    # on the CPU nothing launches, whichever dtype
    before = dict(K.launches)
    _plain(t)
    assert K.launches == before


@pytest.mark.parametrize("name", sorted(ablation.KERNELS["bulge"].variants))
def test_every_ablation_variant_applies_to_the_kernel_source(name):
    """python -m dcgan_sr_tpu_torch.ablation --kernel bulge rebuilds
    csrc/bulge.cu with text substitutions: each must still find its text."""
    src = ablation.variant_source("bulge", name)
    with open(os.path.join(ablation.B.CSRC, "bulge.cu")) as f:
        base = f.read()
    assert (src == base) == (name == "base")


def test_ablation_reads_the_ptxas_lines_of_the_ablated_kernels_only():
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN2tc5statsILi16EEEvv' "
        "for 'sm_90a'",
        "ptxas info    : Used 96 registers, 400 bytes cmem[0]",
        "ptxas info    : Compiling entry function '_ZN3tcb5statsILi16EEEvv' "
        "for 'sm_90a'",
        "ptxas info    : Function properties for _ZN3tcb5statsILi16EEEvv",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 128 registers, 400 bytes cmem[0]"])
    assert ablation.ptxas_lines(log, "_ZN3tcb") == [
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "Used 128 registers, 400 bytes cmem[0]"]
    assert ablation.ptxas_lines(log, "_ZN2tc") == [
        "Used 96 registers, 400 bytes cmem[0]"]
