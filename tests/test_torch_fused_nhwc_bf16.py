"""The channels-last fused pair in bf16 (dcgan_sr_tpu_torch/ops/fused_nhwc.py,
fused_nhwc_mma.py) on the CPU.  The plain bf16 version, which the wrapper
runs on a CPU tensor and which the CUDA kernel's bf16 instantiation is held
to on the card, against the JAX package's fused_convT_bn_relu_conv with bf16
x in interpret mode (Pallas's own kernel, pallas_fused.py) at the three
built channel triples.  Then the packed bf16 version (the kernel's operands,
k order and rounding points, item by item) against the plain one, the
m16n8k16 fragment order with its k permutation, the operands against the
JAX packers, the checks that keep bf16 off the FMA kernel, and bench_fused
in bf16.

Tolerances (as tests/test_torch_bulge_bf16.py).  Statistics are fp32 sums
of the same fp32 hidden tensor in another order: 1e-5 relative.  y is bf16:
within one bf16 step of max|y| (2^(floor(log2 max|y|) - 7)), the planes'
rounding to bf16 and the fp32 sums in another order being the only
differences; the share of elements that differ at all is printed and
bounded by 1%."""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from dcgan_sr_tpu.ops import pallas_fused as JF
from dcgan_sr_tpu_torch import bench_fused
from dcgan_sr_tpu_torch.ops import fused_nhwc as TF
from dcgan_sr_tpu_torch.ops import fused_nhwc_mma as M

from test_torch_bench_fused import JAX_TOOL_KEYS, _run
from test_torch_fused_nhwc_mma import _rect

import torch_threads  # noqa: F401

BF = torch.bfloat16


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


def _hold_stats(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


def _tensors(a):
    t = tuple(map(torch.from_numpy, a))
    return (t[0].to(BF),) + t[1:]


# (B, Ci, Cm, Co, H, W, tm) at the built triples; H a multiple of tm and W
# any width, as the JAX kernel takes them
JAX_GEOMS = [(2, 16, 8, 16, 16, 16, 8), (1, 8, 4, 8, 16, 12, 8),
             (1, 32, 16, 32, 8, 8, 8)]


@pytest.mark.parametrize("geom", JAX_GEOMS, ids=str)
def test_plain_bf16_pair_matches_jax_kernel(geom):
    tm = geom[-1]
    a = _rect(*geom[:6], seed=3)
    y, (m, v) = JF.fused_convT_bn_relu_conv(
        jnp.asarray(a[0], jnp.bfloat16), *map(jnp.asarray, a[1:]), tm=tm,
        interpret=True)
    assert y.dtype == jnp.bfloat16 and m.dtype == jnp.float32
    gy, (gm, gv) = TF.fused_convT_bn_relu_conv(*_tensors(a), tm=tm)
    assert gy.dtype == BF and gm.dtype == torch.float32
    assert tuple(gy.shape) == (geom[0], geom[3], geom[4], geom[5])
    _hold_stats((gm, gv), (m, v))
    _hold_y(gy.float(), np.asarray(y.astype(jnp.float32)),
            f"plain vs JAX K3 {geom}")


# built triples, ragged W, passes clipped at a band's end, two passes a band
PACKED_GEOMS = [(2, 16, 8, 16, 12, 20, 4), (1, 8, 4, 8, 16, 37, 8),
                (1, 32, 16, 32, 8, 33, 8), (1, 16, 8, 16, 32, 40, 16)]


@pytest.mark.parametrize("geom", PACKED_GEOMS, ids=str)
def test_packed_bf16_pair_matches_plain(geom):
    tm = geom[-1]
    t = _tensors(_rect(*geom[:6], seed=5))
    y, st = TF.fused_nhwc_packed(*t, tm=tm)
    assert y.dtype == BF
    yp, stp = TF.fused_nhwc_plain(*t, tm=tm)
    _hold_stats(st, stp)
    _hold_y(y.float(), yp.float(), f"packed vs plain {geom}")


def test_bf16_fragment_order_is_what_an_mma_lane_reads():
    """Lane g*4 + t of mma.m16n8k16 holds, in register j, B[8j + 2t + i]
    [g] (i = 0, 1) of the kernel's k order; with KPERM16 those are channels
    4t + 2j + i, so the lane's four values are channels 4t .. 4t + 3 of
    column g: one 8-byte word at ((ks*NT + nt)*32 + lane)*4.  The lane's A
    registers read channels 4t .. 4t + 3 of its row the same way, and the
    mma over the permuted k gives the plain product."""
    k, n = 32, 24
    mat = torch.arange(k * n, dtype=torch.float32).reshape(k, n)
    frag = M.to_fragments_bf16(mat)
    assert sorted(frag.tolist()) == sorted(mat.reshape(-1).tolist())
    nt_n = n // 8
    for ks in range(k // 16):
        for nt in range(nt_n):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                word = frag[((ks * nt_n + nt) * 32 + lane) * 4:][:4]
                want = mat[ks * 16 + 4 * t:ks * 16 + 4 * t + 4, nt * 8 + g]
                assert torch.equal(word, want)
    unpacked = M.from_fragments_bf16(frag, k, n)
    assert torch.equal(unpacked, M.permute_k16(mat))
    # one m16n8k16 step, assembled from what each lane loads
    rng = np.random.RandomState(0)
    a = torch.from_numpy(rng.randn(16, 16).astype(np.float32))
    b = torch.from_numpy(rng.randn(16, 8).astype(np.float32))
    bf = M.to_fragments_bf16(b)
    a_mma, b_mma = torch.zeros(16, 16), torch.zeros(16, 8)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for row in (g, g + 8):
            u = a[row, 4 * t:4 * t + 4]           # one 8-byte load of A
            for j in range(2):
                for i in range(2):
                    a_mma[row, 8 * j + 2 * t + i] = u[2 * j + i]
        w = bf[lane * 4:lane * 4 + 4]             # one 8-byte load of B
        for j in range(2):
            for i in range(2):
                b_mma[8 * j + 2 * t + i, g] = w[2 * j + i]
    torch.testing.assert_close(a_mma @ b_mma, a @ b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ci,cm,co", M.MMA_TRIPLES)
def test_bf16_operands_unpack_to_the_jax_packers(ci, cm, co):
    """W1 and W2 of the bf16 instantiation, fragment order and k order
    undone and the padding cut, equal the JAX packers' matrices cast to bf16
    (pallas_fused.py:193-194) exactly."""
    _, wT, _, _, wC = _rect(1, ci, cm, co, 4, 4)
    w1, w2 = TF.operands(torch.from_numpy(wT), torch.from_numpy(wC), "mma",
                         BF)
    assert w1.dtype == w2.dtype == BF
    cip, cmp_, cop = M.padded(ci), M.padded(cm), M.padded(co)
    ja = np.asarray(JF._pack_wT(jnp.asarray(wT)).astype(jnp.bfloat16)
                    .astype(jnp.float32))
    jc = np.asarray(JF._pack_wC(jnp.asarray(wC)).astype(jnp.bfloat16)
                    .astype(jnp.float32))
    inv = [M.KPERM16.index(i) for i in range(16)]

    def unpermute16(mat):
        kk = mat.shape[0]
        return mat.reshape(kk // 16, 16, -1)[:, inv].reshape(kk, -1)

    u1 = unpermute16(M.from_fragments_bf16(w1, 4 * cip, 4 * cmp_)).float()
    u1 = u1.reshape(4, cip, 4, cmp_)
    np.testing.assert_array_equal(
        u1[:, :ci, :, :cm].reshape(4 * ci, 4 * cm).numpy(), ja)
    assert not u1[:, ci:].any() and not u1[..., cm:].any()
    u2 = unpermute16(M.from_fragments_bf16(w2, 16 * cmp_, cop)).float()
    u2 = u2.reshape(16, cmp_, cop)
    np.testing.assert_array_equal(u2[:, :cm, :co].reshape(16 * cm, co).numpy(),
                                  jc)
    assert not u2[:, cm:].any() and not u2[..., co:].any()


def test_bf16_refuses_the_fma_kernel_and_unbuilt_triples():
    t = _tensors(_rect(1, 16, 8, 16, 8, 8))
    with pytest.raises(ValueError, match="float32 only"):
        TF.fused_convT_bn_relu_conv(*t, tm=8, impl="fma")
    odd = _tensors(_rect(1, 5, 4, 6, 8, 8))
    with pytest.raises(ValueError, match="no bf16 instantiation"):
        TF.fused_convT_bn_relu_conv(*odd, tm=8)
    assert TF._impl_for(None, 16, 8, 16, 8, 8, bf16=True) == "wgmma"
    assert TF._impl_for(None, 8, 4, 8, 8, 8, bf16=True) == "mma"
    assert all(v == 0 for v in TF.launches.values())


def test_bench_fused_nhwc_bf16_prints_the_jax_tools_keys():
    """bf16 is the default dtype, as in the JAX tool (tools/bench_fused.py:
    31): --kernel nhwc runs K3 bf16 against the unfused bf16 composition."""
    lines = _run(bench_fused.main, ["--cpu", "--batch", "2", "--hw", "16",
                                    "--kernel", "nhwc", "--tm", "8",
                                    "--iters", "1", "--reps", "1"])
    rec = json.loads(lines[-1])
    assert JAX_TOOL_KEYS <= set(rec)
    assert (rec["dtype"], rec["kernel"], rec["device"]) == ("bf16", "nhwc",
                                                            "cpu")
    # y of O(1): the fused pair rounds h once, the unfused layers twice
    assert 0 <= rec["max_abs_diff"] <= 0.125
    counts = json.loads(lines[-2][len("kernel launches: "):])
    assert {"fused_nhwc_stats_bf16", "fused_nhwc_main_bf16"} <= set(counts)
    assert all(v == 0 for v in counts.values())      # CPU: plain versions
