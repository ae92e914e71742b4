"""Checkpoint / resume, npz backend (port of dcgan_sr_tpu/train/checkpoint.py).

The JAX package saves each net as one .npz of flattened pytree leaves keyed
by tree path: `_params_/_3_/_w_`, `_state_/_3_/_bn_/_mean_`, `_ema_/...`,
`_opt_/_m_/...`, `_opt_/_t_`.  The port reads and writes the same files key
for key.  A key is built from the path's elements as jax.tree_util prints
them — a list index as "[3]", a dict key as "['w']" — through the same
`_key` rule, so the two packages cannot drift apart on the format.
"""

from __future__ import annotations

import os
import re

import numpy as np

_SAFE = re.compile(r"[^A-Za-z0-9_.-]+")


def _key(path):
    """Npz key for a tree path — the ON-DISK checkpoint key format; every
    load site builds keys through this one helper."""
    return "/".join(_SAFE.sub("_", str(p)) for p in path)


def checkpoint_path(directory, name, epoch, net):
    # mirrors 'checkpoints/<name>_<epoch>_net_G.t7' naming
    return os.path.join(directory, f"{name}_{epoch}_net_{net}.npz")


def _leaf_paths(tree, prefix=()):
    """(path, leaf) pairs of a nested list/dict tree, path elements spelled
    as jax.tree_util's key entries print ("[i]", "['k']")."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_paths(tree[k], prefix + (f"[{k!r}]",))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaf_paths(v, prefix + (f"[{i}]",))
    else:
        yield prefix, tree


def _rebuild(tree, leaves):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def npz_branches(data):
    """Branch names ('params'/'state'/'opt'/'ema') present in a saved net npz.

    Prefers the explicit `__branches__` manifest; falls back to sniffing the
    flatten-path prefixes for older checkpoints."""
    if "__branches__" in getattr(data, "files", ()):
        return {str(b) for b in data["__branches__"]}
    return {m.group(1) for k in data.files
            if (m := re.match(r"_([A-Za-z0-9]+)_", k))}


def load_branch(data, key, template, *, unpack=False):
    """Restore ONE branch of a saved net npz into `template`'s structure
    (float32 numpy leaves). `data` is an open np.load handle.

    Like the JAX package's load_branch, it reads each leaf by its key; a
    leaf of another shape than the template's raises, except with `unpack`
    a 2-D leaf that is ops/compact.py's packed form of a 4-D one (a
    checkpoint trained with --compact-params), which is unpacked."""
    leaves = []
    for path, leaf in _leaf_paths(template, (f"[{key!r}]",)):
        arr = np.asarray(data[_key(path)], np.float32)
        want = tuple(np.shape(leaf))
        if unpack and len(want) == 4 and arr.shape == (want[0],
                                                       np.prod(want[1:])):
            arr = arr.reshape(want)
        if arr.shape != want:
            raise ValueError(f"shape mismatch for {_key(path)}: "
                             f"{arr.shape} vs {want}")
        leaves.append(arr)
    return _rebuild(template, iter(leaves))


def _save_tree(path, tree):
    """One npz of a dict of branches, each leaf under `_key` of its path:
    written to a same-directory `.tmp` and `os.replace`d into place, so a
    process killed mid-save never leaves a truncated `.npz`."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, __branches__=np.array(sorted(tree)),
                 **{_key(p): leaf for p, leaf in _leaf_paths(tree)})
    os.replace(tmp, path)


def save_generator(path, net):
    """One generator as a `..._net_G.npz` holds it: its "params" and
    "state" branches (Network.trees()), each leaf under `_key` of its tree
    path, written atomically; load_generator reads it back.  A port-only
    model's nested layers give nested paths, e.g.
    `_params_/_1_/_body_/_0_/_body_/_0_/_w_` (README.md)."""
    from .step import _np

    params, state = net.trees()
    _save_tree(path, {"params": _np(params), "state": _np(state)})
    return path


def load_generator(cfg, ckpt=None, *, t7=None, ema=False, need_state=False,
                   device="cuda", seed=0):
    """The generator of `cfg` (a variant's Config or a port-only model's
    SRResNetConfig) as a models.Network on `device`.

    With `ckpt` (a JAX-package or port `..._net_G.npz`) its `params` branch
    (or `ema`) and, when present, its `state` branch carry over key for key;
    a --compact-params checkpoint's 2-D masters are unpacked.  `need_state`
    raises if BN running statistics are missing (bn_eval needs them).
    `t7` (a reference Torch `net_G.t7`, compat/torch_import.py) takes the
    place of `ckpt`: imported over the random init, whose BN running
    statistics stay where the file has none (tools/serve.py and
    tools/upscale.py).  Without either the weights are a random init drawn
    from `seed`.  Returns (net, message)."""
    import torch

    from ..models import Network, generator_spec, init_network

    spec = generator_spec(cfg)
    params, state = init_network(spec, torch.Generator().manual_seed(seed))
    if t7 is not None:
        from ..compat import import_torch_generator
        params, state = import_torch_generator(t7, spec, params, state)
        return (Network(spec, params, state, device=device),
                f"loaded Torch checkpoint {t7}")
    if ckpt is None:
        return (Network(spec, params, state, device=device),
                "WARNING: no checkpoint given; using random init")
    with np.load(ckpt) as data:
        branches = npz_branches(data)
        if ema and "ema" not in branches:
            raise ValueError("--ema needs a checkpoint trained with --g-ema "
                             "(no 'ema' branch found)")
        params = load_branch(data, "ema" if ema else "params", params,
                             unpack=True)
        if "state" in branches:
            state = load_branch(data, "state", state)
        elif need_state:
            raise ValueError("BN running statistics (bn_eval) need a "
                             "checkpoint with a 'state' branch")
    return (Network(spec, params, state, device=device),
            f"loaded checkpoint {ckpt}")


def _net_trees(tree):
    """Per-net branch dicts {"params", "state", "opt"[, "ema"]} of a
    `state_to_numpy` tree."""
    g = {"params": tree["g_params"], "state": tree["g_state"],
         "opt": tree["g_opt"]}
    if tree["g_ema_params"] is not None:
        g["ema"] = tree["g_ema_params"]
    d = {"params": tree["d_params"], "state": tree["d_state"],
         "opt": tree["d_opt"]}
    return (("G", g), ("D", d))


def save_checkpoint(directory, name, epoch, state):
    """Atomic per-net npz saves: each file is written to a same-directory
    `.tmp` and `os.replace`d into place, so a process killed mid-save can
    never leave a truncated `.npz`; at worst a stray `.tmp` remains, which
    `latest_epoch` (anchored on `.npz$`) and every loader ignore."""
    from .step import state_to_numpy

    os.makedirs(directory, exist_ok=True)
    for net, tree in _net_trees(state_to_numpy(state)):
        _save_tree(checkpoint_path(directory, name, epoch, net), tree)
    return epoch


def load_checkpoint(directory, name, epoch, template,
                    seed_missing_ema=False):
    """A new TrainState on the template's device, restored from the two
    npz files into the (freshly initialized) template's structure.

    If the template carries an EMA branch but the npz was saved without
    one, the default is a clear error: callers that score the EMA branch
    must not silently rank raw params labeled as EMA.  Resume call sites
    pass seed_missing_ema=True to seed the EMA from the loaded params and
    keep smoothing from there."""
    from .step import state_from_trees, state_to_numpy

    tmpl = state_to_numpy(template)
    seed_ema = False
    for net, tree in _net_trees(tmpl):
        path = checkpoint_path(directory, name, epoch, net)
        with np.load(path) as data:
            if net == "G" and "ema" in tree and "ema" not in npz_branches(data):
                if not seed_missing_ema:
                    raise ValueError(
                        f"checkpoint {path} has no EMA branch (saved without "
                        "--g-ema); pass seed_missing_ema=True to seed the EMA "
                        "from the loaded params (resume), or load/score the "
                        "raw branch instead")
                print("checkpoint has no EMA branch; seeding g_ema_params "
                      "from the loaded generator params")
                seed_ema = True
            tag = net.lower()
            for branch in ("params", "state"):
                tmpl[f"{tag}_{branch}"] = load_branch(data, branch,
                                                      tree[branch])
            opt = tree["opt"]
            tmpl[f"{tag}_opt"] = {
                **load_branch(data, "opt", {"m": opt["m"], "v": opt["v"]}),
                "t": np.asarray(data[_key(("['opt']", "['t']"))], np.int32)}
            if net == "G" and "ema" in tree:
                tmpl["g_ema_params"] = (
                    tmpl["g_params"] if seed_ema
                    else load_branch(data, "ema", tree["ema"]))
    return state_from_trees(template.g.spec, template.d.spec, tmpl,
                            template.g.device)


def latest_epoch(directory, name):
    if not os.path.isdir(directory):
        return None
    pat = re.compile(re.escape(name) + r"_(\d+)_net_G\.npz$")
    epochs = [int(m.group(1)) for f in os.listdir(directory)
              if (m := pat.match(f))]
    return max(epochs) if epochs else None
