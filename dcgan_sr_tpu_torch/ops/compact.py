"""2-D master-parameter layout for the optimizer (port of
dcgan_sr_tpu/ops/compact.py; the trainer's `--compact-params`).

Each conv weight's master copy, and its Adam moments, is the 2-D matrix
(dim0, rest), e.g. (16, 128) for a (16, 8, 4, 4) weight: a 2-D
nn.Parameter of models/network.py's Layer, which views it as 4-D
(`Layer.weight`) wherever a convolution reads it.  A view, not a copy: the
convolution's weight gradient comes back through the view as a 2-D tensor,
Adam's foreach passes run on the 2-D masters and moments in place, and a
CUDA graph of steps keeps addressing the same tensors.  The update math is
the standard layout's, bit for bit.

Checkpoints written under the flag hold the packed leaves
(`state_to_numpy` carries them as they are), key for key with the JAX
package's `pack_state`; they resume under the same flag.  `unpack_state`
gives the standard layout back, for eval, samples and export.
"""

from __future__ import annotations


def pack_params(params):
    """Each layer's conv weight in its compact 2-D master form (numpy arrays
    or torch tensors; a reshape)."""
    return [
        {k: (v.reshape(v.shape[0], -1) if k == "w" else v)
         for k, v in p.items()}
        for p in params
    ]


def _w_shape(layer):
    k = layer["k"]
    if layer["kind"] == "conv":
        return (layer["cout"], layer["cin"], k, k)  # OIHW
    return (layer["cin"], layer["cout"], k, k)      # IOHW (conv-transpose)


def unpack_params(params, spec):
    """The 4-D conv weights of the 2-D masters (a reshape per weight)."""
    out = []
    for layer, p in zip(spec, params):
        if "w" in p:
            p = dict(p, w=p["w"].reshape(_w_shape(layer)))
        out.append(p)
    return out


def _relaid(state, g_fn, d_fn, g_spec, d_spec):
    """A new TrainState on the state's device: `g_fn`/`d_fn` applied to
    each net's parameters and Adam moments (and G's EMA copy)."""
    from ..train.step import state_from_trees, state_to_numpy

    tree = state_to_numpy(state)
    for tag, fn in (("g", g_fn), ("d", d_fn)):
        tree[f"{tag}_params"] = fn(tree[f"{tag}_params"])
        opt = tree[f"{tag}_opt"]
        tree[f"{tag}_opt"] = {"m": fn(opt["m"]), "v": fn(opt["v"]),
                              "t": opt["t"]}
    if tree["g_ema_params"] is not None:
        tree["g_ema_params"] = g_fn(tree["g_ema_params"])
    return state_from_trees(g_spec, d_spec, tree, state.g.device)


def pack_state(state, g_spec, d_spec):
    """The TrainState with its params AND Adam moments packed."""
    return _relaid(state, pack_params, pack_params, g_spec, d_spec)


def unpack_state(state, g_spec, d_spec):
    """Inverse of pack_state (for eval/inference/checkpoint interchange)."""
    return _relaid(state, lambda p: unpack_params(p, g_spec),
                   lambda p: unpack_params(p, d_spec), g_spec, d_spec)
