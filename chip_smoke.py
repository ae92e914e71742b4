#!/usr/bin/env python3
"""Smoke test of the PyTorch port (dcgan_sr_tpu_torch) on one NVIDIA card.

  python3 chip_smoke.py

Phases, each fatal on failure:
  1. card name and power limit (nvidia-smi); build of every kernel of both
     paths from csrc/ with nvcc (one nvcc per source, started together),
     timed, with the `-Xptxas -v` resource lines.
  2. kernels: the fused bulge kernel (ops/bulge.py, csrc/bulge.cu) against
     its plain PyTorch version on the card (cuDNN with TF32 off), at the
     gray-3 serve shapes x (1,16,256,256), (4,16,1024,1024) and
     (1,16,2048,2048) (the pair's input at LR 32, 128 and 256), in all three BN
     statistics modes, with the fixture's layer-3/4 weights.  Times per call
     for each launch, the plain version and the cuDNN unfused composition.
  3. where a request's time goes: device time of one generator forward at
     LR 256x256, step by step (each layer, and the fused pair), fused and
     unfused, in both BN modes.
  4. path: `python -m dcgan_sr_tpu_torch.serve` on 127.0.0.1 with the
     full-width gray-3 fixture, once with --parity-bn and once with the
     default running-stats BN.  2x requests at LR 32x32, 100x72 and 256x256,
     one restore request, one 8-way concurrent burst, then a run of timed
     256x256 requests; every response is held against the plain-version
     generator's output on the card, and /healthz must show the kernels'
     launch counts move from 0.
  5. kernel: the fused preprocess (ops/preprocess.py, csrc/preprocess.cu)
     against its plain PyTorch version on the card at the trainer's shapes
     (100,1,64,64) flags off, (100,3,64,64) gray+pm1 and pm1 only,
     (1280,1,8,8), the ragged (3,3,50,38), and a bandwidth probe
     (8,3,2048,2048) gray+pm1 that is no path shape.  Times per call for
     the kernel, the plain version and the avg_pool2d composition.
  6. the training step, kernel against plain: from one initial state (seed
     0) and the same two batches, two gray-3 steps at full width (ngf 8,
     ndf 64, batch 100) through build_train_step(cfg) and two through the
     same step with preprocess_plain; the preprocess launch count must move
     by exactly 2, then by 0.
  7. path: `python -m dcgan_sr_tpu_torch.cli --config gray-3 --synthetic
     --steps 6 --scan 2 --epochs 1 --seed 1 --checkpoint-dir <tmp>` as a
     user starts it, at full width: finite losses on reference-shaped log
     lines, 6 preprocess launches on its last line, both checkpoints
     written, the G file loaded through load_generator and used to upscale
     one image, and `--resume` continuing at epoch 2.
  8. where a step's time goes: CUDA events after each stage of the step
     (2 warm-up steps, then 10 queued without waiting in between), the whole
     step in ms and images/s, the host's time to queue a step, peak
     device memory, the same with torch.backends.cudnn.benchmark on, and
     the training generator's forward layer by layer.
  9. a {"kernels": [...]} line, then the contract line
     {"ok": true, "device": {...}}.

Tolerances (max |kernel - plain|, both fp32 on the card):
  mean, var of the hidden tensor  1e-5 abs + 1e-5 rel (tests/test_pallas_fused.py)
  y                               2e-4 abs + 2e-4 rel (the same file): the
                                  fused and cuDNN sums run in different orders
  served PNG bytes                1 level of 255: an fp32 difference of a few
                                  ulp can move a pixel across a rounding edge
  preprocess hr, lr               0: the kernel sums in the plain version's
                                  order and contracts nothing into an FMA
  step, kernel vs plain           hr and lr are bit-equal, but cuDNN's
                                  backward sums atomically, and Adam's first
                                  steps are sign-like: losses rtol 1e-4
                                  (step 1) and rtol 2e-3 / atol 2e-4 (step
                                  2); every updated leaf max |diff| <
                                  2 * 2.1 * lr with at most max(8, 5%) of its
                                  elements off by more than 5e-5
                                  (tests/test_torch_train_step.py)
"""

import http.client
import io
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(REPO, "fixtures", "gray3_textured_net_G.npz")
TOL_STATS = 1e-5
TOL_Y = 2e-4
TOL_U8 = 1
# published H100 SXM peaks: fp32 outside the tensor cores, HBM bandwidth
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
SHAPES = [(1, 16, 256, 256), (4, 16, 1024, 1024), (1, 16, 2048, 2048)]


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def time_ms(fn, iters):
    import torch
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_FP32, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_phase(params, state):
    import torch
    import torch.nn.functional as F

    from dcgan_sr_tpu_torch.ops import bulge as K
    from dcgan_sr_tpu_torch.ops import nn as N

    dev = torch.device("cuda")
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    wT, wC = t(params[3]["w"]), t(params[4]["w"])
    scale, bias = t(params[3]["bn_scale"]), t(params[3]["bn_bias"])
    rmean, rvar = t(state[3]["bn"]["mean"]), t(state[3]["bn"]["var"])
    ci, cm, co = wT.shape[0], wT.shape[1], wC.shape[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    err = {"bulge_stats": 0.0, "bulge_main": 0.0}
    rows = []
    for shape in SHAPES:
        b, _, h, w = shape
        x = torch.rand(shape, generator=gen, device=dev)
        for mode in K.STATS_MODES:
            run = (rmean, rvar) if mode == "running" else None
            y, (m, v) = K.bulge(x, wT, scale, bias, wC, stats=mode,
                                running=run)
            yp, (mp, vp) = K.bulge_plain(x, wT, scale, bias, wC, stats=mode,
                                         running=run)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(y).all()), f"non-finite y {shape} {mode}")
            ey = (y - yp).abs().max().item()
            em = (m - mp).abs().max().item()
            ev = (v - vp).abs().max().item()
            ok_y = bool(((y - yp).abs() <= TOL_Y + TOL_Y * yp.abs()).all())
            ok_s = bool(((m - mp).abs() <= TOL_STATS + TOL_STATS * mp.abs()).all()
                        and ((v - vp).abs() <= TOL_STATS + TOL_STATS * vp.abs()).all())
            print(f"kernel {shape} {mode:9s} max|dy| {ey:.3e} "
                  f"max|dmean| {em:.3e} max|dvar| {ev:.3e}", flush=True)
            check(ok_y and ok_s, f"bulge kernel disagrees with its plain "
                  f"version at {shape} {mode}")
            err["bulge_main"] = max(err["bulge_main"], ey)
            if mode != "running":
                err["bulge_stats"] = max(err["bulge_stats"], em, ev)
            del y, yp

        # times per call at this shape
        iters = 20 if h <= 256 else 5
        mu = rmean.expand(b, cm).contiguous()
        gain = (torch.rsqrt(rvar + 1e-5) * scale).expand(b, cm).contiguous()
        xs = x.contiguous()
        with N.fp32_convs():
            lib_stats = lambda: torch.var_mean(  # noqa: E731
                F.conv_transpose2d(xs, wT, stride=2, padding=1),
                dim=(2, 3), correction=0)
            lib_pair_run = lambda: F.conv2d(F.relu(F.batch_norm(  # noqa: E731
                F.conv_transpose2d(xs, wT, stride=2, padding=1), rmean, rvar,
                scale, bias, training=False)), wC, stride=2, padding=1)
            lib_pair_img = lambda: F.conv2d(F.relu(F.instance_norm(  # noqa: E731
                F.conv_transpose2d(xs, wT, stride=2, padding=1),
                weight=scale, bias=bias)), wC, stride=2, padding=1)
            r = {
                "stats_ms": time_ms(lambda: K.launch_stats(xs, wT), iters),
                "main_ms": time_ms(lambda: K.launch_main(xs, wT, wC, mu, gain,
                                                         bias), iters),
                "pair_img_ms": time_ms(lambda: K.bulge(
                    xs, wT, scale, bias, wC, stats="per_image"), iters),
                "pair_run_ms": time_ms(lambda: K.bulge(
                    xs, wT, scale, bias, wC, stats="running",
                    running=(rmean, rvar)), iters),
                "plain_stats_ms": time_ms(lambda: N.batch_stats(
                    N.conv_transpose2d(xs, wT, 2, 1), per_image=True), iters),
                "plain_main_ms": time_ms(lambda: K.bulge_plain(
                    xs, wT, scale, bias, wC, stats="running",
                    running=(rmean, rvar)), iters),
                "plain_pair_img_ms": time_ms(lambda: K.bulge_plain(
                    xs, wT, scale, bias, wC, stats="per_image"), iters),
                "lib_stats_ms": time_ms(lib_stats, iters),
                "lib_main_ms": time_ms(lib_pair_run, iters),
                "lib_pair_img_ms": time_ms(lib_pair_img, iters),
            }
        hw = b * h * w
        flops_convT = 2 * 16 * hw * ci * cm
        flops_conv = 2 * 16 * hw * co * cm
        bytes_x, bytes_y = 4 * hw * ci, 4 * hw * co
        tiles = -(-h // 16) * -(-w // 16)
        r["stats_bound"] = bound(flops_convT + 3 * 4 * hw * cm,
                                 bytes_x + 4 * wT.numel() + 4 * b * tiles * 2 * cm)
        r["main_bound"] = bound(flops_convT + 3 * 4 * hw * cm + flops_conv,
                                bytes_x + bytes_y + 4 * (wT.numel() + wC.numel()
                                                         + 2 * b * cm + cm))
        print(f"times {shape}: " + json.dumps(
            {k: (round(v, 4) if isinstance(v, float) else
                 [round(v[0], 4), v[1]]) for k, v in r.items()}), flush=True)
        rows.append((shape, r))
        del x, xs
        torch.cuda.empty_cache()
    return err, rows


# ---------------------------------------------------------------------------
# phase 3: where a forward's time goes
# ---------------------------------------------------------------------------

def forward_breakdown(net, x, bn_stats, iters=5):
    """Mean device ms of one generator forward and of each step in it: a
    layer between its module hooks, or a fused pair (which runs outside
    any layer's call) in the gap between two layers' hooks."""
    import torch

    marks = []

    def mark(tag):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks.append((tag, e))

    hooks = []
    for i, layer in enumerate(net.layers):
        hooks.append(layer.register_forward_pre_hook(
            lambda m, a, i=i: mark(("start", i))))
        hooks.append(layer.register_forward_hook(
            lambda m, a, o, i=i: mark(("end", i))))
    acc = {}
    try:
        with torch.inference_mode():
            net(x, bn_stats=bn_stats)
            for _ in range(iters):
                marks.clear()
                mark(("start", None))
                net(x, bn_stats=bn_stats)
                mark(("end", None))
                torch.cuda.synchronize()
                for (a, e0), (b, e1) in zip(marks, marks[1:]):
                    if a[0] == "start" and b[0] == "end" and a[1] == b[1]:
                        kind = net.spec[a[1]]["kind"]
                        label = f"layer {a[1]} {kind}"
                    elif a[0] == "end" and b[0] == "start" and a[1] is not None \
                            and b[1] is not None and b[1] > a[1] + 1:
                        label = f"layers {a[1] + 1}-{b[1] - 1} fused pair"
                    else:
                        label = "between layers"
                    acc[label] = acc.get(label, 0.0) + e0.elapsed_time(e1)
                acc["total"] = acc.get("total", 0.0) + \
                    marks[0][1].elapsed_time(marks[-1][1])
    finally:
        for h in hooks:
            h.remove()
    return {k: round(v / iters, 4) for k, v in acc.items()}


# ---------------------------------------------------------------------------
# phase 4: the served path
# ---------------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _png(arr8):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr8).save(buf, format="PNG")
    return buf.getvalue()


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _healthz(port):
    status, body = _request(port, "GET", "/healthz")
    check(status == 200, f"/healthz answered {status}")
    return json.loads(body)


def serve_phase(cfg, parity, ref_service, log):
    """Start the port's server, drive it, hold every response against
    `ref_service` (the plain-version generator on the card).  Returns the
    server's kernel launch counts and the timed-request latencies."""
    import numpy as np
    from PIL import Image

    from dcgan_sr_tpu_torch.image.io import load_image

    port = _free_port()
    cmd = [sys.executable, "-m", "dcgan_sr_tpu_torch.serve", "--config",
           cfg.variant, "--ckpt", FIXTURE, "--port", str(port),
           "--max-batch", "8"]
    if parity:
        cmd.append("--parity-bn")
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
    name = "parity-bn" if parity else "running-stats BN"
    try:
        t0 = time.monotonic()
        while True:
            check(proc.poll() is None, f"server ({name}) exited with "
                  f"{proc.returncode}")
            try:
                h0 = _healthz(port)
                break
            except (ConnectionError, OSError):
                check(time.monotonic() - t0 < 180, "server did not come up")
                time.sleep(0.5)
        print(f"server ({name}) up in {time.monotonic() - t0:.1f}s", flush=True)
        check(h0["device"].startswith("cuda"), f"server on {h0['device']}")
        check(all(v == 0 for v in h0["kernel_launches"].values()),
              f"launch counts not 0 at start: {h0['kernel_launches']}")

        rng = np.random.RandomState(1 if parity else 2)
        worst = 0

        def post(arr8, mode="2x"):
            nonlocal worst
            body = _png(arr8)
            q = "?mode=restore" if mode == "restore" else ""
            status, out = _request(port, "POST", "/upscale" + q, body)
            check(status == 200, f"POST {arr8.shape} {mode}: {status} {out[:200]}")
            got = np.asarray(Image.open(io.BytesIO(out)), np.int16)
            h, w = arr8.shape
            want_hw = (2 * h, 2 * w) if mode == "2x" else (h, w)
            check(got.shape == want_hw, f"response {got.shape} != {want_hw}")
            img = load_image(io.BytesIO(body), nc=1)[0]
            ref = ref_service.submit(img, mode)
            ref8 = np.clip(np.round(ref * 255.0), 0, 255).astype(np.int16)
            d = int(np.abs(got - ref8).max())
            worst = max(worst, d)
            check(d <= TOL_U8, f"response differs from the plain generator by "
                  f"{d} levels ({arr8.shape}, {mode})")

        for hw in ((32, 32), (100, 72), (256, 256)):
            post((rng.rand(*hw) * 255).astype(np.uint8))
        post((rng.rand(200, 160) * 255).astype(np.uint8), "restore")
        burst = [(rng.rand(64, 64) * 255).astype(np.uint8) for _ in range(8)]
        b0 = _healthz(port)["batches"]
        errors = []

        def run(th):
            try:
                th()
            except Exception as e:  # reported below, after the join
                errors.append(e)

        gate = threading.Barrier(len(burst))   # all 8 POSTs leave together
        threads = [threading.Thread(target=run, args=(
            lambda a=a: (gate.wait(timeout=60), post(a)),)) for a in burst]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        check(not errors and not any(th.is_alive() for th in threads),
              f"burst failed: {errors}")
        burst_batches = _healthz(port)["batches"] - b0
        check(burst_batches < 8, "8 concurrent requests did not coalesce")

        # timed requests: LR 256x256 -> 512x512, sequential, one warm first
        body = _png((rng.rand(256, 256) * 255).astype(np.uint8))
        lat = []
        for _ in range(11):
            t1 = time.perf_counter()
            status, _ = _request(port, "POST", "/upscale", body)
            lat.append((time.perf_counter() - t1) * 1e3)
            check(status == 200, f"timed request answered {status}")
        lat = sorted(lat[1:])
        hz = _healthz(port)
        print(f"timed ({name}): client ms {[round(v, 2) for v in lat]}; "
              f"server batch ms (last 10) "
              f"{hz['recent_batch_ms'][-10:]}", flush=True)
        check(hz["errors"] == 0, f"server counted {hz['errors']} errors")
        check(hz["requests"] >= 3 + 1 + 8 + 11, f"requests {hz['requests']}")
        print(f"served ({name}): {hz['requests']} images in {hz['batches']} "
              f"batches (burst of 8 in {burst_batches}), max byte diff vs "
              f"plain {worst}, launches {hz['kernel_launches']}, "
              f"batch_ms p50 {hz['batch_ms_p50']}", flush=True)
        return hz["kernel_launches"], lat, burst_batches
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


# ---------------------------------------------------------------------------
# phase 5: the preprocess kernel against its plain version
# ---------------------------------------------------------------------------

# (shape, rgb_to_gray, to_pm1, is a shape of the training path)
PRE_CASES = [((100, 1, 64, 64), False, False, True),
             ((100, 3, 64, 64), True, True, True),
             ((100, 3, 64, 64), False, True, True),
             ((1280, 1, 8, 8), False, False, True),
             ((3, 3, 50, 38), True, True, False),
             ((8, 3, 2048, 2048), True, True, False)]


def preprocess_phase():
    import torch
    import torch.nn.functional as F

    from dcgan_sr_tpu_torch.ops import preprocess as P

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    worst, rows = 0.0, []
    for shape, gray, pm1, on_path in PRE_CASES:
        x = torch.rand(shape, generator=gen, device=dev)
        n0 = P.launches["preprocess"]
        hr, lr = P.preprocess(x, rgb_to_gray=gray, to_pm1=pm1)
        check(P.launches["preprocess"] == n0 + 1, "launch count did not move")
        hp, lp = P.preprocess_plain(x, rgb_to_gray=gray, to_pm1=pm1)
        torch.cuda.synchronize()
        check(hr.shape == hp.shape and lr.shape == lp.shape,
              f"preprocess shapes {tuple(hr.shape)} {tuple(lr.shape)}")
        check(bool(torch.isfinite(hr).all() and torch.isfinite(lr).all()),
              f"non-finite preprocess output {shape}")
        e_hr = (hr - hp).abs().max().item()
        e_lr = (lr - lp).abs().max().item()
        worst = max(worst, e_hr, e_lr)
        check(e_hr == 0.0 and e_lr == 0.0, f"preprocess kernel differs from "
              f"its plain version at {shape} gray={gray} pm1={pm1}: "
              f"hr {e_hr:.3e} lr {e_lr:.3e}")

        def library():
            y = x
            if gray:
                y = 0.21 * y[:, 0:1] + 0.72 * y[:, 1:2] + 0.07 * y[:, 2:3]
            if pm1:
                y = y * 2.0 - 1.0
            if y is x:
                y = x.clone()         # hr is an output: written once
            return y, F.avg_pool2d(y, 2)

        iters = 10 if x.numel() > 1 << 24 else 200
        n_in, n_hr, n_lr = x.numel(), hr.numel(), lr.numel()
        flops = n_hr * ((5 if gray else 0) + (2 if pm1 else 0)) + 4 * n_lr
        b_ms, b_by = bound(flops, 4 * (n_in + n_hr + n_lr))
        r = {"shape": list(shape), "gray": gray, "pm1": pm1,
             "on_path": on_path, "max_abs_err": max(e_hr, e_lr),
             "ms": time_ms(lambda: P.preprocess(
                 x, rgb_to_gray=gray, to_pm1=pm1), iters),
             "plain_ms": time_ms(lambda: P.preprocess_plain(
                 x, rgb_to_gray=gray, to_pm1=pm1), iters),
             "library_ms": time_ms(library, iters),
             "bound_ms": b_ms, "bound_by": b_by,
             "GB_per_s": None}
        r["GB_per_s"] = 4 * (n_in + n_hr + n_lr) / (r["ms"] * 1e-3) / 1e9
        print("preprocess " + json.dumps(
            {k: (round(v, 5) if isinstance(v, float) else v)
             for k, v in r.items()}), flush=True)
        rows.append(r)
        del x, hr, lr, hp, lp
        torch.cuda.empty_cache()
    return worst, rows


# ---------------------------------------------------------------------------
# phase 6: the training step, kernel against plain
# ---------------------------------------------------------------------------

def _batches(cfg, n, device):
    """n consecutive trainer batches of the procedural source, on the card."""
    import numpy as np
    import torch

    from dcgan_sr_tpu_torch.data.synthetic import SyntheticImages
    src = SyntheticImages(cfg.fineSize, nc=cfg.nc, seed=1234)
    return [torch.from_numpy(np.ascontiguousarray(
        src.load_batch(i, cfg.batchSize))).to(device) for i in range(n)]


def step_phase(cfg):
    import numpy as np
    import torch

    from dcgan_sr_tpu_torch.ops import preprocess as P
    from dcgan_sr_tpu_torch.train.step import (build_train_step,
                                               init_train_state,
                                               state_from_numpy,
                                               state_to_numpy)

    dev = torch.device("cuda")
    st = init_train_state(cfg, torch.Generator().manual_seed(0), device=dev)
    twin = state_from_numpy(cfg, state_to_numpy(st), device=dev)
    batches = _batches(cfg, 2, dev)
    check(tuple(batches[0].shape) == (100, 1, 64, 64),
          f"trainer batch is {tuple(batches[0].shape)}")
    runs = []
    for state, fn, moves in ((st, P.preprocess, 2), (twin, P.preprocess_plain, 0)):
        step = build_train_step(cfg, preprocess_fn=fn)
        n0 = P.launches["preprocess"]
        losses = []
        for hr in batches:
            _, m = step(state, hr)
            losses.append({k: v.item() for k, v in m.items()})
        torch.cuda.synchronize()
        check(P.launches["preprocess"] - n0 == moves,
              f"preprocess launches moved by {P.launches['preprocess'] - n0}, "
              f"expected {moves}")
        runs.append(losses)
    for it, (a, b) in enumerate(zip(*runs)):
        tol = (1e-4, 0.0) if it == 0 else (2e-3, 2e-4)
        for k in a:
            check(np.isfinite(a[k]) and np.isfinite(b[k]), f"{k} not finite")
            check(abs(a[k] - b[k]) <= tol[1] + tol[0] * abs(b[k]),
                  f"step {it + 1} {k}: kernel {a[k]} vs plain {b[k]}")
    worst, flips = 0.0, 0
    ta, tb = state_to_numpy(st), state_to_numpy(twin)
    for field in ("g_params", "d_params"):
        for la, lb in zip(ta[field], tb[field]):
            for key in la:
                diff = np.abs(la[key] - lb[key])
                worst = max(worst, float(diff.max()))
                off = int((diff > 5e-5).sum())
                flips += off
                check(diff.max() < 2 * 2.1 * cfg.lr and
                      off <= max(8, 0.05 * diff.size),
                      f"{field} {key}: max diff {diff.max():.3e}, {off} of "
                      f"{diff.size} off")
    check(st.g_opt["t"] == twin.g_opt["t"] == 2, "Adam step counts")
    print(f"step kernel-vs-plain: losses {json.dumps(runs[0])}; plain "
          f"{json.dumps(runs[1])}; max leaf diff {worst:.3e}, {flips} elements "
          f"off by more than 5e-5", flush=True)
    return st


# ---------------------------------------------------------------------------
# phase 7: the trainer as users start it
# ---------------------------------------------------------------------------

LOG_LINE = re.compile(
    r"^Epoch: \[(\d+)\]\[ *(\d+) / *(\d+)\]\t Time: [\d.]+  DataTime: [\d.]+  "
    r"  Err_G: ([\d.eE+-]+|nan|inf)  Err_D: ([\d.eE+-]+|nan|inf)$")
# variables the config reads as overrides: a stray one would change the width
CONFIG_ENV = ("batchSize", "ngf", "ndf", "ntrain", "niter", "name", "lr",
              "fineSize", "loadSize", "nThreads")


def _trainer(args):
    env = {k: v for k, v in os.environ.items() if k not in CONFIG_ENV}
    cmd = [sys.executable, "-m", "dcgan_sr_tpu_torch.cli", *args]
    r = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=600)
    if r.returncode != 0:
        sys.stderr.write(r.stdout[-4000:] + r.stderr[-8000:])
    check(r.returncode == 0, f"{' '.join(cmd)} exited with {r.returncode}")
    return r.stdout.splitlines()


def trainer_phase(cfg):
    import math

    import numpy as np
    import torch

    from dcgan_sr_tpu_torch.infer.tiled import make_full_sr_fn
    from dcgan_sr_tpu_torch.train.checkpoint import (checkpoint_path,
                                                     load_generator)

    with tempfile.TemporaryDirectory() as ck:
        t0 = time.perf_counter()
        lines = _trainer(["--config", "gray-3", "--synthetic", "--steps", "6",
                          "--scan", "2", "--epochs", "1", "--seed", "1",
                          "--checkpoint-dir", ck])
        wall = time.perf_counter() - t0
        check("ngf=8" in lines[0] and "ndf=64" in lines[0]
              and "batchSize=100" in lines[0], f"not full width: {lines[0]}")
        steps = [LOG_LINE.match(l) for l in lines if l.startswith("Epoch:")]
        check(len(steps) == 3 and all(steps), f"log lines: {lines}")
        check([m.group(2) for m in steps] == ["1", "3", "5"]
              and all(m.group(1) == "1" and m.group(3) == "6" for m in steps),
              "log lines are not the ends of three 2-step chunks of 6")
        vals = [float(m.group(i)) for m in steps for i in (4, 5)]
        check(len(vals) == 6 and all(math.isfinite(v) for v in vals),
              f"Err_G/Err_D not finite: {vals}")
        check(lines[-1].startswith("kernel launches: "), lines[-1])
        counts = json.loads(lines[-1][len("kernel launches: "):])
        check(counts["preprocess"] == 6, f"trainer launched {counts}")
        for net in "GD":
            check(os.path.isfile(checkpoint_path(ck, cfg.name, 1, net)),
                  f"no epoch-1 checkpoint of net {net}")
        for l in lines[1:]:
            print("trainer| " + l, flush=True)
        print(f"trainer: 6 steps of batch 100 in {wall:.1f}s of process time "
              f"(start, build reuse, init, data, steps, checkpoints)",
              flush=True)

        # the trained G serves: load as the server does, upscale one image
        net, _ = load_generator(cfg, checkpoint_path(ck, cfg.name, 1, "G"),
                                need_state=True, device="cuda")
        lr = torch.rand((1, 1, 48, 40), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(5))
        fake = make_full_sr_fn(net, lr_input=True)(lr)
        torch.cuda.synchronize()
        check(tuple(fake.shape) == (1, 1, 96, 80)
              and bool(torch.isfinite(fake).all())
              and 0.0 <= fake.min().item() and fake.max().item() <= 1.0,
              f"upscale from the trained G: {tuple(fake.shape)}")

        lines = _trainer(["--config", "gray-3", "--synthetic", "--steps", "2",
                          "--epochs", "2", "--seed", "1", "--checkpoint-dir",
                          ck, "--resume"])
        check("resumed from epoch 1" in lines, "did not resume")
        steps = [LOG_LINE.match(l) for l in lines if l.startswith("Epoch:")]
        check(len(steps) == 2 and all(m and m.group(1) == "2" for m in steps),
              "resume did not start at epoch 2")
        check(os.path.isfile(checkpoint_path(ck, cfg.name, 2, "G")),
              "no epoch-2 checkpoint after resume")
        with np.load(checkpoint_path(ck, cfg.name, 2, "G")) as data:
            check(int(data["_opt_/_t_"]) == 8, "Adam step count after resume")
        return counts


# ---------------------------------------------------------------------------
# phase 8: where a step's time goes
# ---------------------------------------------------------------------------

STAGES = ("preprocess", "g_forward", "d_real_forward_backward",
          "d_fake_forward", "d_fake_pullbacks", "g_backward", "adam_updates")


def step_breakdown(cfg, state, smi, warm=2, iters=10):
    """Device time of each stage of the step, from CUDA events the step
    records as it queues each stage.  The host queues all `iters` steps
    without waiting (as the trainer does between two log lines), so a
    stage's time is the device's, not the host's time to enqueue it; the
    step's own time is the wall clock over the steps, ending in a
    synchronize."""
    import torch

    from dcgan_sr_tpu_torch.train.step import build_train_step

    dev = torch.device("cuda")
    step = build_train_step(cfg)
    batches = _batches(cfg, 4, dev)
    out = {}
    for bench in (False, True):
        torch.backends.cudnn.benchmark = bench
        try:
            for i in range(warm):
                step(state, batches[i % len(batches)])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            marks = []

            def mark(name):
                e = torch.cuda.Event(enable_timing=True)
                e.record()
                marks.append((name, e))

            t0 = time.perf_counter()
            for i in range(iters):
                mark("start")
                step(state, batches[i % len(batches)], mark=mark)
            queued = (time.perf_counter() - t0) / iters * 1e3
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / iters * 1e3
        finally:
            torch.backends.cudnn.benchmark = False
        check([n for n, _ in marks] == (["start"] + list(STAGES)) * iters,
              f"stages {[n for n, _ in marks[:len(STAGES) + 1]]}")
        acc = dict.fromkeys(STAGES, 0.0)
        for (_, e0), (name, e1) in zip(marks, marks[1:]):
            if name != "start":
                acc[name] += e0.elapsed_time(e1)
        r = {k: round(v / iters, 4) for k, v in acc.items()}
        r["stages_sum_ms"] = round(sum(acc.values()) / iters, 4)
        r["host_queue_ms"] = round(queued, 4)
        r["step_ms"] = round(wall, 4)
        r["images_per_s"] = round(cfg.batchSize / (wall / 1e3), 2)
        r["peak_memory_GB"] = round(torch.cuda.max_memory_allocated() / 1e9, 3)
        print(f"step breakdown, batch {cfg.batchSize}, cudnn.benchmark="
              f"{bench} (ms, mean of {iters}) on {smi}: " + json.dumps(r),
              flush=True)
        out[bench] = r
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import numpy as np

    from dcgan_sr_tpu_torch.core import get_config
    from dcgan_sr_tpu_torch.models import Network, generator_spec, init_network
    from dcgan_sr_tpu_torch.ops import bulge as K
    from dcgan_sr_tpu_torch.ops import preprocess as P
    from dcgan_sr_tpu_torch.serve import SRService
    from dcgan_sr_tpu_torch.train.checkpoint import load_branch

    # phase 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    took, failed = {}, []

    def build(mod, name):
        try:
            mod.build()
            took[name] = time.perf_counter() - t0
        except Exception as e:      # re-raised below, on the main thread
            failed.append(e)

    threads = [threading.Thread(target=build, args=(mod, name))
                for mod, name in ((K, "bulge"), (P, "preprocess"))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if failed:
        raise failed[0]
    for mod, name in ((K, "bulge"), (P, "preprocess")):
        print(f"build: csrc/{name}.cu done {took[name]:.1f}s after both "
              f"nvcc runs started", flush=True)
        print(mod.build_log.strip(), flush=True)

    cfg = get_config("gray-3", env_override=False)
    spec = generator_spec(cfg)
    params, state = init_network(spec, torch.Generator().manual_seed(0))
    with np.load(FIXTURE) as data:
        params = load_branch(data, "params", params)
        state = load_branch(data, "state", state)

    # phase 2
    errs, rows = kernel_phase(params, state)

    # phase 3
    plain = Network(spec, params, state, device="cuda", fuse=False)
    fused = Network(spec, params, state, device="cuda")
    x = torch.rand((1, 1, 256, 256), device="cuda",
                   generator=torch.Generator(device="cuda").manual_seed(1))
    for bn_stats in ("running", "per_image"):
        for label, net in (("fused", fused), ("unfused", plain)):
            print(f"forward LR 256x256 {bn_stats} {label} (ms): " + json.dumps(
                forward_breakdown(net, x, bn_stats)), flush=True)
    del fused, x
    torch.cuda.empty_cache()

    # phase 4: counts start at 0 in each fresh server process
    launches = {"bulge_stats": 0, "bulge_main": 0}
    lat_all = {}
    with tempfile.TemporaryFile() as log:
        try:
            for parity in (True, False):
                ref = SRService(cfg, plain, max_batch=8, window_ms=0,
                                bn_eval=not parity, u8_io=True)
                try:
                    counts, lat, _ = serve_phase(cfg, parity, ref, log)
                finally:
                    ref.close()
                for k, v in counts.items():
                    launches[k] += v
                lat_all["parity-bn" if parity else "running"] = lat
        except Exception:
            log.seek(0)
            sys.stderr.write(log.read().decode(errors="replace")[-8000:])
            raise
    for k, v in launches.items():
        check(v > 0, f"kernel {k} was not launched on the served path")
    for name, lat in lat_all.items():
        p50 = lat[len(lat) // 2]
        print(f"latency ({name}) LR 256x256 -> 512x512: p50 {p50:.2f} ms, "
              f"{0.512 * 0.512 / (p50 / 1e3):.2f} MP/s out, on {smi}",
              flush=True)

    del plain
    torch.cuda.empty_cache()

    # phases 5-8: the training path
    pre_err, pre_rows = preprocess_phase()
    state = step_phase(cfg)
    trainer_counts = trainer_phase(cfg)
    check(trainer_counts["preprocess"] > 0,
          "the preprocess kernel was not launched on the trained path")
    breakdown = step_breakdown(cfg, state, smi)
    x = torch.rand((100, 1, 32, 32), device="cuda",
                   generator=torch.Generator(device="cuda").manual_seed(2))
    for bench in (False, True):
        torch.backends.cudnn.benchmark = bench
        try:
            fwd = forward_breakdown(state.g, x, "pooled")
        finally:
            torch.backends.cudnn.benchmark = False
        print(f"training G forward, batch 100 LR 32x32, unfused, "
              f"cudnn.benchmark={bench} (ms): " + json.dumps(fwd), flush=True)
    print(f"train step, gray-3 full width, batch 100: "
          f"{breakdown[False]['step_ms']} ms, "
          f"{breakdown[False]['images_per_s']} images/s, peak "
          f"{breakdown[False]['peak_memory_GB']} GB, on {smi}", flush=True)

    # phase 9
    shape, r = rows[-1]
    kernels = []
    for name, line, key, plain_key, lib_key in (
            ("bulge_stats", 159, "stats", "plain_stats_ms", "lib_stats_ms"),
            ("bulge_main", 206, "main", "plain_main_ms", "lib_main_ms")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "dcgan_sr_tpu_torch/csrc/bulge.cu",
            "replaces": f"dcgan_sr_tpu/ops/pallas_bulge.py:{line}",
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": r[f"{key}_ms"], "plain_ms": r[plain_key],
            "bound_ms": r[f"{key}_bound"][0],
            "bound_by": r[f"{key}_bound"][1],
            "library_ms": r[lib_key], "shape": list(shape)})
    r = pre_rows[0]       # the trainer's own call: (100, 1, 64, 64), flags off
    kernels.append({
        "name": "preprocess", "route": "cuda",
        "source": "dcgan_sr_tpu_torch/csrc/preprocess.cu",
        "replaces": "dcgan_sr_tpu/ops/pallas_kernels.py:64",
        "launches": trainer_counts["preprocess"], "max_abs_err": pre_err,
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        "shape": r["shape"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
