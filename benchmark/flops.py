"""Operations and bytes of the work a cell does, counted from shapes.

`conv_flops` is a copy of dcgan_sr_tpu_torch/attr_overlap.py's count (2 x
every multiply-add); `train_step_flops` counts a GAN step's products as the
step runs them; `pair_work` counts the fused convT + BN + ReLU + conv pair's
operations and its least bytes (each input byte read once, each output
byte written once).
"""

from __future__ import annotations


def _out_hw(layer, hw):
    k, s, p = layer["k"], layer["s"], layer["p"]
    if layer["kind"] == "convT":
        return (hw - 1) * s - 2 * p + k
    return (hw + 2 * p - k) // s + 1


def conv_flops(spec, hw):
    """FLOPs of one (1, cin, hw, hw) input through `spec`'s convolutions."""
    flops = 0
    for layer in spec:
        kind = layer["kind"]
        if kind == "upsample":
            hw *= layer["factor"]
        elif kind in ("conv", "convT"):
            macs = layer["cin"] * layer["cout"] * layer["k"] ** 2
            out = _out_hw(layer, hw)
            # a convT's multiply-adds scale with its input, a conv's with
            # its output
            flops += 2 * macs * (hw * hw if kind == "convT" else out * out)
            hw = out
    return flops


def _per_layer_flops(spec, hw):
    """[forward FLOPs of each conv layer] for one (1, cin, hw, hw) input."""
    out = []
    for layer in spec:
        kind = layer["kind"]
        if kind == "upsample":
            hw *= layer["factor"]
        elif kind in ("conv", "convT"):
            one = conv_flops((layer,), hw)
            out.append(one)
            hw = _out_hw(layer, hw)
    return out


def train_step_flops(g_spec, d_spec, lr_hw, hr_hw):
    """Model FLOPs of one image through a GAN train step, as the step runs
    its products: G forward, its weight gradients and its input gradients
    but the first layer's (the data needs none); D on the real batch the
    same; D on the fake batch its forward, its weight gradients, the input
    gradients of the pullback to D's parameters (but the first layer's)
    and those of the pullback to the fake image (every layer).  Nothing is
    counted twice for a recomputation."""
    g = _per_layer_flops(g_spec, lr_hw)
    d = _per_layer_flops(d_spec, hr_hw)
    g_total = 3 * sum(g) - g[0]
    d_real = 3 * sum(d) - d[0]
    d_fake = 3 * sum(d) - d[0] + sum(d)
    return g_total + d_real + d_fake


def pair_work(batch, ci, cm, co, h, w, elem_bytes):
    """(operations, least bytes) of y = conv(relu(bn(convT(x)))) on x of
    (batch, ci, h, w): both k4s2p1 products, the statistics of the hidden
    tensor (a sum and a sum of squares) and its normalisation and ReLU;
    x read once, y (batch, co, h, w) written once, both weights read once."""
    hidden = batch * cm * 4 * h * w
    macs = batch * h * w * 16 * cm * (ci + co)
    ops = 2 * macs + 3 * hidden + 3 * hidden
    nbytes = (batch * h * w * (ci + co) * elem_bytes
              + 16 * cm * (ci + co) * elem_bytes + 2 * cm * 4)
    return ops, nbytes
