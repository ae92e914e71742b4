"""One rank of the data-parallel CPU tests (tests/test_torch_parallel.py,
tests/test_torch_dp.py): joins a gloo group through a file store, runs one
job and writes its results to <out>/rank<r>.npz for the test process to
read.  It imports torch and the port, never jax.

  python tests/torch_dp_worker.py JOB RANK WORLD STORE OUT [ARGS_JSON]

Jobs: "parallel" (collectives and cross-replica BN over the world and over
a two-rank sub-mesh), "dp" (the DP step, its K-step chunk, the
device-augment and patch batches, sharded SR), "cli" (the trainer and
upscale under --dp, from the launcher's environment variables).
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

import torch_threads  # noqa: F401

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dcgan_sr_tpu_torch.core import get_config  # noqa: E402
from dcgan_sr_tpu_torch.models import generator_spec, init_network  # noqa: E402
from dcgan_sr_tpu_torch.ops import nn as N  # noqa: E402
from dcgan_sr_tpu_torch.parallel import (  # noqa: E402
    all_gather, axis_index, axis_size, build_dp_multi_step,
    build_dp_train_step, create_mesh, device_count, initialize_distributed,
    local_batch_slice, pmean, ppermute, psum, reduce_scatter, shard_batch)

WORKER = os.path.abspath(__file__)
TINY = dict(env_override=False, ngf=4, ndf=8)
BN_SHAPE = (8, 3, 4, 4)


def flat(tree, prefix, out):
    """numpy leaves of a nested dict/list tree under '/'-joined keys."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat(v, f"{prefix}/{k}", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flat(v, f"{prefix}/{i}", out)
    elif tree is not None:
        out[prefix] = np.asarray(tree.detach().cpu() if
                                 isinstance(tree, torch.Tensor) else tree)


def bn_inputs():
    """The cross-replica BN case's global inputs (the test process draws
    the same)."""
    rng = np.random.RandomState(0)
    x = rng.randn(*BN_SHAPE).astype(np.float32) * 2 + 0.5
    w = rng.rand(*BN_SHAPE).astype(np.float32)
    t = rng.randn(*BN_SHAPE).astype(np.float32)
    scale = (rng.rand(3) + 0.5).astype(np.float32)
    bias = rng.randn(3).astype(np.float32)
    return x, w, t, scale, bias


def bn_case(mesh, out, tag):
    """Each rank's slice through cross-replica BN, the local weighted MSE
    differentiated (x, scale, bias), the parameter gradients pmean'd as the
    step does."""
    x, w, t, scale, bias = (torch.from_numpy(a) for a in bn_inputs())
    sl = local_batch_slice(BN_SHAPE[0], mesh.size, mesh.rank)
    xl = x[sl].clone().requires_grad_(True)
    sc = scale.clone().requires_grad_(True)
    bi = bias.clone().requires_grad_(True)
    state = {"mean": torch.zeros(3), "var": torch.ones(3)}
    y, new = N.batch_norm(xl, sc, bi, state=state, axis_name=mesh)
    loss = (w[sl] * (y - t[sl]) ** 2).mean()
    gx, gs, gb = torch.autograd.grad(loss, (xl, sc, bi))
    gs, gb = pmean([gs, gb], mesh)
    for k, v in (("y", y), ("gx", gx), ("gscale", gs), ("gbias", gb),
                 ("mean", new["mean"]), ("var", new["var"])):
        out[f"{tag}/{k}"] = v.detach().numpy()


def collectives_case(mesh, out, tag):
    r, n = mesh.rank, mesh.size
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * r
    out[f"{tag}/psum"] = psum(x, mesh).numpy()
    out[f"{tag}/pmean"] = pmean(x, mesh).numpy()
    out[f"{tag}/pmean_list"] = torch.cat(
        [v.reshape(-1) for v in pmean([x, x[0] * 2], mesh)]).numpy()
    out[f"{tag}/all_gather"] = all_gather(x, mesh).numpy()
    out[f"{tag}/all_gather_stacked"] = all_gather(x, mesh, axis=1,
                                                  tiled=False).numpy()
    # a ring shift, and a permutation that leaves rank 0 without a sender
    out[f"{tag}/ppermute_ring"] = ppermute(
        x, mesh, [(i, (i + 1) % n) for i in range(n)]).numpy()
    out[f"{tag}/ppermute_partial"] = ppermute(
        x, mesh, [(i, i + 1) for i in range(n - 1)]).numpy()
    big = torch.arange(4 * n, dtype=torch.float32).reshape(2 * n, 2) * (r + 1)
    out[f"{tag}/reduce_scatter"] = reduce_scatter(big, mesh).numpy()
    out[f"{tag}/index_size"] = np.array([axis_index(mesh), axis_size(mesh)])
    # the transpose: d/dx sum(psum(x) * c) = the ranks' sum of c
    xg = x.clone().requires_grad_(True)
    c = torch.full_like(x, float(r + 1))
    (g,) = torch.autograd.grad((psum(xg, mesh) * c).sum(), xg)
    out[f"{tag}/psum_grad"] = g.numpy()


def job_parallel(out):
    world = create_mesh()
    out["device_count"] = np.array(device_count())
    collectives_case(world, out, "world")
    bn_case(world, out, "world")
    pair = create_mesh(2)        # every rank calls it; ranks 2.. get None
    if pair is not None:
        collectives_case(pair, out, "pair")
        bn_case(pair, out, "pair")
    out["pair_is_none"] = np.array(pair is None)


def _state(cfg, weights=None, double=False):
    from dcgan_sr_tpu_torch.train.checkpoint import load_checkpoint
    from dcgan_sr_tpu_torch.train.step import init_train_state
    st = init_train_state(cfg, torch.Generator().manual_seed(1), device="cpu")
    if weights is not None:
        st = load_checkpoint(weights, cfg.name, 0, st)
    if double:
        st.g.double(), st.d.double()
        for opt in (st.g_opt, st.d_opt):
            opt["m"] = [m.double() for m in opt["m"]]
            opt["v"] = [v.double() for v in opt["v"]]
    return st


def _metrics(m):
    return np.array([float(m[k]) for k in sorted(m)])


def job_dp(out, args):
    """Every collective runs on both ranks in the same order; the
    single-device references (no collective) are split between the ranks."""
    from dcgan_sr_tpu_torch.infer.tiled import (make_full_sr_fn,
                                                make_overlap_sr_fn)
    from dcgan_sr_tpu_torch.models import Network
    from dcgan_sr_tpu_torch.ops.preprocess import preprocess_plain
    from dcgan_sr_tpu_torch.train.step import build_train_step, state_to_numpy

    mesh = create_mesh()
    lead = mesh.rank == 0
    rng = np.random.RandomState(7)
    # the DP step, gray-3 at global batch 16, two steps from the JAX init's
    # weights (the test process runs the JAX step on the same batches)
    cfg = get_config("gray-3", batchSize=16, **TINY)
    batches = rng.rand(2, 16, 1, 64, 64).astype(np.float32)
    st = _state(cfg, args["weights"])
    step = build_dp_train_step(cfg, mesh)
    for i in range(2):
        st, m = step(st, shard_batch(batches[i], mesh))
        out[f"step/metrics{i}"] = _metrics(m)
        flat(state_to_numpy(st), f"step/state{i}", out)

    # float64: the DP step and the single-device step, one step at global
    # batch 4; only the DP decomposition differs
    x64 = torch.from_numpy(rng.rand(4, 1, 64, 64)).double()
    chunk = torch.from_numpy(rng.rand(3, 4, 1, 64, 64).astype(np.float32))
    kw = dict(preprocess_fn=preprocess_plain)
    if lead:
        st1, _ = build_train_step(cfg, **kw)(_state(cfg, double=True), x64)
        flat(state_to_numpy(st1), "f64_single", out)
    else:
        # the K-step chunk's single-device reference: three steps
        st1, errs = _state(cfg), []
        for j in range(3):
            st1, m = build_train_step(cfg)(st1, chunk[j])
            errs.append(float(m["errG"]))
        out["multi_single/errG"] = np.array(errs)
        flat(state_to_numpy(st1)["g_params"], "multi_single/g_params", out)
    st, _ = build_dp_train_step(cfg, mesh, **kw)(
        _state(cfg, double=True), shard_batch(x64, mesh))
    flat(state_to_numpy(st), "f64_dp", out)

    # K = 3 steps in one call (global batch 4) against three single steps
    st, ms = build_dp_multi_step(cfg, mesh)(
        _state(cfg), shard_batch(chunk, mesh, batch_dim=1))
    out["multi/errG"] = ms["errG"].numpy()
    flat(state_to_numpy(st)["g_params"], "multi/g_params", out)

    # device_augment: the (canvas, tops, lefts, flips) tuple shards leaf by
    # leaf, each shard the global batch's rows of this rank
    acfg = get_config("gray", device_augment=True, device_preprocess=True,
                      batchSize=4, **TINY)
    batch = (torch.from_numpy(rng.rand(4, 3, 96, 96).astype(np.float32)),
             torch.from_numpy(rng.randint(1, 33, size=4).astype(np.int32)),
             torch.from_numpy(rng.randint(1, 33, size=4).astype(np.int32)),
             torch.from_numpy(rng.rand(4) > 0.5))
    local = shard_batch(batch, mesh)
    sl = local_batch_slice(4, mesh.size, mesh.rank)
    out["augment/rows_match"] = np.array(
        all(torch.equal(a, g[sl]) for a, g in zip(local, batch)))
    _, m = build_dp_train_step(acfg, mesh)(_state(acfg), local)
    out["augment/dp"] = _metrics(m)

    # one patch variant: 20 images' 8x8 grids = 1280 tiles, 640 a rank
    pcfg = get_config("gray-patch-batch", batchSize=20, ngf=4,
                      env_override=False)
    tiles = torch.from_numpy(rng.rand(1280, 1, 8, 8).astype(np.float32))
    _, m = build_dp_train_step(pcfg, mesh)(_state(pcfg),
                                           shard_batch(tiles, mesh))
    out["patch/dp"] = _metrics(m)
    if lead:
        _, m = build_train_step(acfg)(_state(acfg), batch)
        out["augment/single"] = _metrics(m)
        _, m = build_train_step(pcfg)(_state(pcfg), tiles)
        out["patch/single"] = _metrics(m)

    # sharded SR (an image a rank) against the same call without a mesh;
    # rank 0 runs the unsharded calls of per-image BN, rank 1 of running BN
    ocfg = get_config("gray-patch-batch-overlap", **TINY)
    onet = Network(generator_spec(ocfg), *init_network(
        generator_spec(ocfg), torch.Generator().manual_seed(2)), device="cpu")
    imgs = torch.from_numpy(rng.rand(2, 64, 64).astype(np.float32))
    lr = torch.from_numpy(rng.rand(2, 32, 32).astype(np.float32))
    for bn_eval in (False, True):
        for lr_input, x in ((False, imgs), (True, lr)):
            tag = f"overlap/{int(bn_eval)}{int(lr_input)}"
            kw = dict(bn_eval=bn_eval, lr_input=lr_input)
            sharded = make_overlap_sr_fn(ocfg, onet, mesh=mesh, **kw)(x)
            mine = lead != bn_eval
            alone = make_overlap_sr_fn(ocfg, onet, **kw)(x) if mine else {}
            for k in ("naive", "seam"):
                out[f"{tag}/{k}"] = sharded[k].numpy()
                if mine:
                    out[f"{tag}/{k}_alone"] = alone[k].numpy()
    fnet = Network(generator_spec(cfg), *init_network(
        generator_spec(cfg), torch.Generator().manual_seed(3)), device="cpu")
    full = torch.from_numpy(rng.rand(4, 1, 32, 32).astype(np.float32))
    for bn_eval in (False, True):
        out[f"full/{int(bn_eval)}"] = make_full_sr_fn(
            fnet, mesh=mesh, bn_eval=bn_eval)(full).numpy()
        if lead != bn_eval:
            out[f"full/{int(bn_eval)}_alone"] = make_full_sr_fn(
                fnet, bn_eval=bn_eval)(full).numpy()


def job_cli(out, args):
    """The trainer, then upscale, each under --dp from the launcher's
    environment (each joins and leaves the group itself).  The trainer's
    checkpoint saves are counted on each rank."""
    from dcgan_sr_tpu_torch import cli, upscale
    from dcgan_sr_tpu_torch.train import loop

    dist.destroy_process_group()         # the entry points join their own
    os.environ.update({"RANK": str(args["rank"]),
                       "WORLD_SIZE": str(args["world"]),
                       "LOCAL_RANK": str(args["rank"]),
                       "MASTER_ADDR": "localhost"})
    saves, save = [], loop.save_checkpoint
    loop.save_checkpoint = lambda *a, **k: (saves.append(a[2]), save(*a, **k))
    logs = {}
    for name, main, port in (("cli", cli.main, args["ports"][0]),
                             ("upscale", upscale.main, args["ports"][1])):
        os.environ["MASTER_PORT"] = str(port)
        env = args.get(f"{name}_env", {})
        os.environ.update(env)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(args[name])
        for k in env:
            del os.environ[k]
        logs[name] = buf.getvalue()
    out["log"] = np.array(json.dumps(logs))
    out["saves"] = np.array(saves, dtype=np.int64)


def launch(job, world, tmp, args="{}", timeout=240):
    """The test side: `world` gloo ranks of this worker, started together;
    their npz files as dicts, rank by rank."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    store = os.path.join(tmp, "store")
    logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, WORKER, job, str(r), str(world), store, str(tmp),
         args], stdout=logs[r], stderr=subprocess.STDOUT, env=env)
        for r in range(world)]
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            p.kill()
        for r, (p, log) in enumerate(zip(procs, logs)):
            log.seek(0)
            text = log.read()
            log.close()
            assert p.returncode == 0, f"rank {r}:\n{text[-4000:]}"
    out = []
    for r in range(world):
        with np.load(os.path.join(tmp, f"rank{r}.npz")) as z:
            out.append({k: z[k] for k in z.files})
    return out


def main():
    job, rank, world, store, outdir = sys.argv[1:6]
    args = json.loads(sys.argv[6]) if len(sys.argv) > 6 else {}
    rank, world = int(rank), int(world)
    args.update(rank=rank, world=world)
    initialize_distributed(f"file://{store}", world, rank, backend="gloo")
    out = {}
    if job == "parallel":
        job_parallel(out)
    elif job == "dp":
        job_dp(out, args)
    else:
        job_cli(out, args)
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
