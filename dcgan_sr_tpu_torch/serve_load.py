"""HTTP load client for `python -m dcgan_sr_tpu_torch.serve`: measured
serving latency and throughput (the port's own copy of tools/serve_load.py,
which imports neither JAX nor the JAX package).

It POSTs a generated PNG to /upscale: first one cold request (reported on
its own; a GET of /healthz before it keeps the client's own first-call
setup out of its time), then N sequential warm requests, then R rounds of C-way
concurrent bursts, and prints one JSON line per phase plus the server's
/healthz dispatch percentiles.  The client stays lean (the bytes are
encoded once and reused; responses are drained, not decoded): on a host
with few cores the load generator shares them with the server, so the
concurrent figures are lower bounds.

  python -m dcgan_sr_tpu_torch.serve_load --port 8200 --size 128x128 \
      --warm 20 --concurrency 8 --rounds 4
"""

from __future__ import annotations

import argparse
import io
import json
import statistics
import threading
import time
import urllib.request


def make_png(h, w, nc=1, seed=0):
    import numpy as np
    from PIL import Image
    rng = np.random.RandomState(seed)
    arr = (rng.rand(h, w, nc) * 255).astype("uint8")
    img = Image.fromarray(arr[..., 0] if nc == 1 else arr,
                          mode="L" if nc == 1 else "RGB")
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


def post(url, body, timeout=600):
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": "image/png"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        out = r.read()  # drain; do NOT decode (keeps the client lean)
    return time.perf_counter() - t0, len(out)


def healthz(base):
    with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
        return json.loads(r.read())


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--size", default="128x128", help="HxW of the LR input")
    ap.add_argument("--nc", type=int, default=1)
    ap.add_argument("--warm", type=int, default=20,
                    help="sequential warm requests (one cold discarded first)")
    ap.add_argument("--concurrency", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args(argv)

    h, w = (int(d) for d in args.size.split("x"))
    body = make_png(h, w, args.nc)
    base = f"http://{args.host}:{args.port}"
    url = base + "/upscale"

    # a GET first: urllib's first call builds its opener (an SSL context,
    # tens of ms on the client), which would otherwise land on the cold
    # request's time
    healthz(base)
    cold, nbytes = post(url, body)
    print(json.dumps({"phase": "cold_first", "s": round(cold, 3),
                      "resp_bytes": nbytes}), flush=True)

    if args.warm > 0:
        seq = [post(url, body)[0] for _ in range(args.warm)]
        print(json.dumps({
            "phase": "warm_single", "n": args.warm,
            "median_ms": round(statistics.median(seq) * 1e3, 1),
            "min_ms": round(min(seq) * 1e3, 1),
            "max_ms": round(max(seq) * 1e3, 1)}), flush=True)

    rates = []  # per-round completed-requests/s (failed requests excluded)
    for r in range(args.rounds):
        results = [None] * args.concurrency

        def worker(i):
            try:
                results[i] = post(url, body)[0]
            except Exception as e:  # keep the burst alive; reported below
                results[i] = repr(e)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(args.concurrency)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        ok = [t for t in results if isinstance(t, float)]
        rates.append(len(ok) / wall)
        print(json.dumps({
            "phase": "concurrent", "round": r, "c": args.concurrency,
            "wall_ms": round(wall * 1e3, 1),
            "req_per_s": round(len(ok) / wall, 1),
            "req_ms": [round(t * 1e3, 1) for t in ok],
            "errors": [t for t in results if not isinstance(t, float)],
        }), flush=True)

    if rates:
        # steady state: round 0 can meet a shape's first call, so the
        # summary reports medians both with and without it
        warm_rates = rates[1:] or rates
        print(json.dumps({
            "phase": "concurrent_summary", "rounds": args.rounds,
            "c": args.concurrency,
            "median_req_per_s": round(statistics.median(rates), 1),
            "warm_median_req_per_s": round(
                statistics.median(warm_rates), 1)}), flush=True)

    hz = healthz(base)
    print(json.dumps({"phase": "healthz",
                      **{k: hz.get(k) for k in
                         ("requests", "batches", "errors",
                          "batch_ms_p50", "batch_ms_p95")}}), flush=True)


if __name__ == "__main__":
    main()
