"""validate_bf16's initial state: the JAX tool's own, carried into the port.

tools/validate_bf16.py starts both of its runs from the JAX package's
`init_train_state(gray-3, PRNGKey(5))`.  That state (weights and BN
statistics, fp32; Adam's moments are zeros with t = 0 and are not stored) is
committed as fixtures/gray3_jax_init_key5.npz, one array a leaf under
`<field>/<layer>/<name>[/<name>]`, and `python -m
dcgan_sr_tpu_torch.validate_bf16` starts from it.  The tests, on the CPU:

  (a) the fixture equals the JAX package's init at PRNGKey(5), full width,
      bit for bit, under either compute_dtype (the init does not depend on
      it, so one file serves both of the tool's runs);
  (b) the port's loader (`validate_bf16.jax_init`) gives the JAX state's
      tree, Adam's zero moments included, and the same port state through
      `state_from_numpy`;
  (c) `validate_bf16.main(["--cpu"])` hands `run` the fixture's arrays;
  (d) `run(init=...)` against the JAX tool's body from one JAX init at NGF
      4, NDF 8, batch 4, one step (k = 1), each dtype's fp32-scored
      G-PSNR / G-SSIM, both packages scored over held-out set 100 at batch
      10 (the tool's two sets of 50 through G on one thread would be most
      of the time).  fp32: within the eval's parity tolerances, 1e-3 dB
      and 1e-4.  bf16: |port - JAX| <= 2 |JAX bf16 - JAX fp32| + the fp32
      tolerance (the rule of tests/test_torch_bf16_step.py: bf16's own
      effect sets the bound).

The fixture is written through the JAX package, never by the port:

  python tests/test_torch_validate_init.py --write

and the small-width study of bf16's effect in both packages from the same
JAX inits (100 steps, K = 20; PERF.md §7) runs as

  python tests/test_torch_validate_init.py --study [--keys 5 0 1 2]
      [--ngf 4 --ndf 8 --batch 8 --steps 100 --k 20] [--ulp]

`--ulp` also runs both packages from each init with every weight moved by
one ulp (`nudged`), and `--trace [--ops]` holds the port's bf16 run to the
JAX package's step by step (`trace`).
"""

import contextlib
import io
import os
import sys

import numpy as np
import pytest

import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "fixtures", "gray3_jax_init_key5.npz")
FIELDS = ("g_params", "g_state", "d_params", "d_state")
TOL_FP32 = (1e-3, 1e-4)          # G-PSNR dB, G-SSIM


def _flat(tree, prefix):
    """{"prefix/<layer>/<name>[/<name>]": fp32 numpy array} of a per-layer
    list of (nested) dicts."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: np.asarray(tree, np.float32)}


def jax_init_fields(key=5, compute_dtype="float32", **overrides):
    """The JAX package's gray-3 TrainState at PRNGKey(key), batch 100 as the
    tool's, as numpy in state_to_numpy's layout."""
    import jax

    from dcgan_sr_tpu.core import get_config
    from dcgan_sr_tpu.train.step import init_train_state

    cfg = get_config("gray-3", env_override=False, batchSize=100,
                     compute_dtype=compute_dtype, **overrides)
    st = init_train_state(cfg, jax.random.PRNGKey(key))
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return {f: np_tree(getattr(st, f)) for f in
            FIELDS + ("g_opt", "d_opt", "g_ema_params")}


def fixture_arrays(fields):
    out = {}
    for f in FIELDS:
        out.update(_flat(fields[f], f))
    return out


# the tool's eval slice: (file sets, batch size)
TOOL_EVAL = (range(100, 102), 50)


def jax_tool(key, steps, batch, k, init=None, scored=TOOL_EVAL,
             **overrides):
    """tools/validate_bf16.py's run() body through the JAX package's own
    functions, from PRNGKey(key) (or from `init`, numpy fields as
    `jax_init_fields` gives them), scored in fp32 over `scored`: {dtype:
    EvalResult}."""
    import jax
    import jax.numpy as jnp

    from dcgan_sr_tpu.core import get_config
    from dcgan_sr_tpu.data import SyntheticImages
    from dcgan_sr_tpu.evaluation import evaluate_slice
    from dcgan_sr_tpu.infer.tiled import make_generator_fn
    from dcgan_sr_tpu.train import init_train_state
    from dcgan_sr_tpu.train.multi_step import jit_multi_step
    from dcgan_sr_tpu.train.step import TrainState

    src = SyntheticImages(fine_size=64, nc=1, seed=11)
    batches = jnp.asarray(
        np.stack([src.load_batch(s, batch) for s in range(k)]))
    results = {}
    for dtype in ("float32", "bfloat16"):
        cfg = get_config("gray-3", env_override=False, batchSize=batch,
                         compute_dtype=dtype, **overrides)
        state = (init_train_state(cfg, jax.random.PRNGKey(key))
                 if init is None else TrainState(**jax.tree_util.tree_map(
                     jnp.asarray, init)))
        mstep = jit_multi_step(cfg)
        for _ in range(steps // k):
            state, _ = mstep(state, batches)
        gen = make_generator_fn(cfg)
        results[dtype] = evaluate_slice(cfg, gen, state.g_params,
                                        state.g_state, src, scored[0],
                                        batch_size=scored[1])
    return results


def port_tool(init, steps, batch, k, scored=TOOL_EVAL, **overrides):
    """The port's `validate_bf16.run(init=...)` on the CPU, its scores taken
    over `scored` in place of the tool's slice: ({dtype: EvalResult} in run
    order, its output lines)."""
    from dcgan_sr_tpu_torch import validate_bf16

    results = []
    score = validate_bf16.evaluate_slice

    def spy(cfg, gen, loader, file_sets, batch_size=None, **kw):
        assert (list(file_sets), batch_size) == (list(TOOL_EVAL[0]),
                                                 TOOL_EVAL[1])
        results.append(score(cfg, gen, loader, scored[0],
                             batch_size=scored[1], **kw))
        return results[-1]

    buf = io.StringIO()
    validate_bf16.evaluate_slice = spy
    try:
        with contextlib.redirect_stdout(buf):
            validate_bf16.run(steps=steps, batch=batch, k=k, device="cpu",
                              init=init, **overrides)
    finally:
        validate_bf16.evaluate_slice = score
    return (dict(zip(("float32", "bfloat16"), results)),
            buf.getvalue().splitlines())


# ---- tests ------------------------------------------------------------------

def _fixture():
    with np.load(FIXTURE) as data:
        return {k: data[k] for k in data.files}


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_fixture_is_the_jax_init_at_key_5(compute_dtype):
    want = fixture_arrays(jax_init_fields(5, compute_dtype))
    got = _fixture()
    assert sorted(got) == sorted(want)
    assert sum(a.size for n, a in want.items() if "_params/" in n) == 2785232
    for name, a in want.items():
        assert got[name].dtype == np.float32 and a.dtype == np.float32, name
        assert np.array_equal(got[name], a), name


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def test_loader_gives_the_jax_state():
    import torch

    from dcgan_sr_tpu_torch import validate_bf16
    from dcgan_sr_tpu_torch.core import get_config
    from dcgan_sr_tpu_torch.train.step import state_from_numpy, state_to_numpy

    want = jax_init_fields(5)
    got = validate_bf16.jax_init()
    assert got["g_ema_params"] is None and want["g_ema_params"] is None
    for f in FIELDS + ("g_opt", "d_opt"):
        g, w = list(_leaves(got[f])), list(_leaves(want[f]))
        assert [n for n, _ in g] == [n for n, _ in w], f
        for (name, a), (_, b) in zip(g, w):
            assert np.asarray(a).dtype == np.asarray(b).dtype, f + name
            assert np.array_equal(a, b), f + name
    cfg = get_config("gray-3", env_override=False, batchSize=100)
    sg = state_to_numpy(state_from_numpy(cfg, got, device="cpu"))
    sw = state_to_numpy(state_from_numpy(cfg, want, device="cpu"))
    for f in sw:
        g, w = list(_leaves(sg[f])), list(_leaves(sw[f]))
        assert [n for n, _ in g] == [n for n, _ in w], f
        assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(g, w)), f
    assert int(sg["g_opt"]["t"]) == int(sg["d_opt"]["t"]) == 0
    assert torch.get_num_threads() == 1


def test_cli_starts_from_the_fixture(monkeypatch):
    from dcgan_sr_tpu_torch import validate_bf16

    calls = []

    def run(**kw):
        calls.append(kw)
        return True

    monkeypatch.setattr(validate_bf16, "run", run)
    assert validate_bf16.main(["--cpu"]) is True
    assert len(calls) == 1 and str(calls[0]["device"]) == "cpu"
    assert set(calls[0]) == {"device", "init"}
    got = fixture_arrays(calls[0]["init"])
    want = _fixture()
    assert sorted(got) == sorted(want)
    assert all(np.array_equal(got[n], want[n]) for n in want)
    for opt in ("g_opt", "d_opt"):
        assert int(calls[0]["init"][opt]["t"]) == 0
        assert all(not np.any(a) for _, a in _leaves(
            [calls[0]["init"][opt]["m"], calls[0]["init"][opt]["v"]]))


SMALL = dict(ngf=4, ndf=8)
SMALL_EVAL = (range(100, 101), 10)


def test_run_from_a_jax_init_matches_the_jax_tool():
    jax_res = jax_tool(5, steps=1, batch=4, k=1, scored=SMALL_EVAL, **SMALL)
    init = jax_init_fields(5, **SMALL)
    port_res, lines = port_tool(init, steps=1, batch=4, k=1,
                                scored=SMALL_EVAL, **SMALL)
    assert lines[0].startswith("float32  : G-PSNR ")
    assert lines[1].startswith("bfloat16 : G-PSNR ")
    assert lines[2].startswith("delta PSNR ")
    for dtype in ("float32", "bfloat16"):
        assert port_res[dtype].n_images == jax_res[dtype].n_images == 10
    for f, tol in zip(("psnr_generator", "ssim_generator"), TOL_FP32):
        j32, jbf = (getattr(jax_res[d], f) for d in ("float32", "bfloat16"))
        p32, pbf = (getattr(port_res[d], f) for d in ("float32", "bfloat16"))
        assert np.isfinite([p32, pbf]).all()
        assert abs(p32 - j32) <= tol, f"fp32 {f}: port {p32}, JAX {j32}"
        bound = 2 * abs(jbf - j32) + tol
        assert abs(pbf - jbf) <= bound, (
            f"bf16 {f}: port {pbf}, JAX {jbf} (JAX fp32 {j32}): "
            f"{abs(pbf - jbf):.3e} > {bound:.3e}")


# ---- the fixture writer and the study ---------------------------------------

def write_fixture(path=FIXTURE):
    arrays = fixture_arrays(jax_init_fields(5))
    np.savez(path, **arrays)
    print(f"wrote {path}: {len(arrays)} arrays, "
          f"{sum(a.size for a in arrays.values())} values")


def nudged(fields):
    """`fields` with every weight moved by one ulp toward +inf (the BN
    statistics and Adam's moments as they were): an init that differs from
    the drawn one by rounding alone."""
    out = dict(fields)
    for f in ("g_params", "d_params"):
        out[f] = [{n: np.nextafter(a, np.float32(np.inf)) for n, a in
                   p.items()} for p in fields[f]]
    return out


def study(keys, ngf, ndf, batch, steps, k, ulp=False):
    """Each key: both packages' fp32 and bf16 G-PSNR / G-SSIM and |delta|,
    the port started from that key's JAX init; with `ulp`, both packages
    again from that init nudged by one ulp (`nudged`): how far rounding
    alone moves a run of this length."""
    import json
    import time

    def scores(res):
        row = {d: [res[d].psnr_generator, res[d].ssim_generator]
               for d in ("float32", "bfloat16")}
        row["delta"] = [abs(row["bfloat16"][i] - row["float32"][i])
                        for i in (0, 1)]
        return row

    for key in keys:
        init = jax_init_fields(key, ngf=ngf, ndf=ndf)
        runs = {"jax": lambda i: jax_tool(key, steps, batch, k, init=i,
                                          ngf=ngf, ndf=ndf),
                "port": lambda i: port_tool(i, steps, batch, k, ngf=ngf,
                                            ndf=ndf)[0]}
        row = {"key": key, "ngf": ngf, "ndf": ndf, "batch": batch,
               "steps": steps, "k": k, "seconds": {}}
        for tag, fn in runs.items():
            for start, st in (("", None), ("_ulp", nudged(init)))[:1 + ulp]:
                t0 = time.time()
                row[tag + start] = scores(fn(st if start else
                                             (None if tag == "jax" else init)))
                row["seconds"][tag + start] = round(time.time() - t0, 1)
        print(json.dumps(row), flush=True)


def trace(key, ngf, ndf, batch, steps, k, jit_ref):
    """tools/validate_bf16.py's bf16 run step by step (batch i % k at step
    i, as its K-step scan feeds them): from the JAX bf16 state before each
    step, one step of the port's bf16 step, of the JAX package's bf16 step
    (jitted, as the tool runs it, or op by op with `jit_ref` False, as
    tests/test_torch_bf16_step.py does) and of its fp32 step, held by that
    file's rule (port-bf16 to JAX-bf16 within twice JAX-bf16 to JAX-fp32
    plus a floor: losses, Adam's moments, BN statistics, parameters).
    Prints each step's failures and the first failing step."""
    import json

    import jax
    import jax.numpy as jnp
    import torch

    from dcgan_sr_tpu.core import get_config as j_get_config
    from dcgan_sr_tpu.data import SyntheticImages
    from dcgan_sr_tpu.train.step import (build_train_step as j_build,
                                         init_train_state as j_init)
    from dcgan_sr_tpu_torch.core import get_config
    from dcgan_sr_tpu_torch.train.step import (build_train_step,
                                               state_from_numpy,
                                               state_to_numpy)
    from test_torch_bf16_step import (METRICS, _fields, _hold, _hold_norm,
                                      _leaves)

    kw = dict(env_override=False, ngf=ngf, ndf=ndf, batchSize=batch)
    jbf = j_get_config("gray-3", compute_dtype="bfloat16", **kw)
    cfg = get_config("gray-3", compute_dtype="bfloat16", **kw)
    ref = j_build(jbf)
    steps_of = {"bf16": jax.jit(ref) if jit_ref else ref,
                "fp32": jax.jit(j_build(j_get_config("gray-3", **kw)))}
    tstep = build_train_step(cfg)
    src = SyntheticImages(fine_size=64, nc=1, seed=11)
    batches = [src.load_batch(s, batch) for s in range(k)]
    jst = j_init(jbf, jax.random.PRNGKey(key))
    first = None
    for i in range(steps):
        hr = batches[i % k]
        tst = state_from_numpy(cfg, _fields(jst), device="cpu")
        tst, m = tstep(tst, torch.from_numpy(hr))
        snap = {"port": ({n: float(v) for n, v in m.items()},
                         state_to_numpy(tst))}
        after = {}
        for tag, fn in steps_of.items():
            after[tag], m = fn(jst, jnp.asarray(hr))
            snap[tag] = ({n: float(v) for n, v in m.items()},
                         _fields(after[tag]))
        jst = after["bf16"]
        fails = []

        def held(fn, *a):
            try:
                fn(*a)
            except AssertionError as e:
                fails.append(str(e).splitlines()[0])

        for n in METRICS:
            held(_hold, *(np.float64(snap[t][0][n]) for t in
                          ("port", "bf16", "fp32")), 1e-6, n)
        for opt in ("g_opt", "d_opt"):
            for mom in ("m", "v"):
                trees = [[v for _, v in _leaves(snap[t][1][opt][mom])]
                         for t in ("port", "bf16", "fp32")]
                held(_hold_norm, *trees, f"{opt}.{mom}")
        for field in ("g_state", "d_state"):
            for (name, a), (_, b), (_, c) in zip(*(
                    _leaves(snap[t][1][field]) for t in
                    ("port", "bf16", "fp32"))):
                held(_hold, a, b, c, 1e-6, field + name)
        for field in ("g_params", "d_params"):
            for (name, a), (_, b), (_, c) in zip(*(
                    _leaves(snap[t][1][field]) for t in
                    ("port", "bf16", "fp32"))):
                d = np.abs(a - b)
                off = int((d > cfg.lr / 4).sum())
                ref_off = int((np.abs(b - c) > cfg.lr / 4).sum())
                if not (d.max() < 2.1 * cfg.lr and off <= 2 * ref_off + 2):
                    fails.append(f"{field}{name}: max {d.max():.3e}, "
                                 f"{off} elements off (fp32 {ref_off})")
        if fails and first is None:
            first = i + 1
        print(json.dumps({"step": i + 1, "errG": [snap[t][0]["errG"] for t in
                                                   ("port", "bf16", "fp32")],
                          "failures": fails}), flush=True)
    print(json.dumps({"key": key, "jit_ref": jit_ref, "steps": steps,
                      "first_failing_step": first}), flush=True)


if __name__ == "__main__":
    import argparse

    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--write", action="store_true")
    ap.add_argument("--study", action="store_true")
    ap.add_argument("--ulp", action="store_true",
                    help="--study: also from the init nudged by one ulp")
    ap.add_argument("--trace", action="store_true",
                    help="the bf16 run step by step against the JAX steps")
    ap.add_argument("--ops", action="store_true",
                    help="--trace: the JAX bf16 step op by op, not jitted")
    ap.add_argument("--keys", type=int, nargs="+", default=[5, 0, 1, 2])
    ap.add_argument("--ngf", type=int, default=4)
    ap.add_argument("--ndf", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--k", type=int, default=20)
    args = ap.parse_args()
    if args.write:
        write_fixture()
    if args.study:
        study(args.keys, args.ngf, args.ndf, args.batch, args.steps, args.k,
              args.ulp)
    if args.trace:
        for key in args.keys:
            trace(key, args.ngf, args.ndf, args.batch, args.steps, args.k,
                  not args.ops)
