"""K train steps per call (port of dcgan_sr_tpu/train/multi_step.py).

The JAX package scans K steps into ONE XLA program (lax.scan under jit, the
state donated): one dispatch per K steps.  The counterpart on a card is a
CUDA graph: `build_multi_step(cfg)` returns a runner that, on a CUDA state,
keeps one graph per chunk shape and works in four stages:

  1. the first chunk of a shape runs eagerly, as K single steps on a side
     stream: real training (the state is not saved and restored), and the
     warm-up a capture needs: the kernels are built, cuDNN picks its
     algorithms, autograd and cuDNN create their handles;
  2. then K steps are captured into one `torch.cuda.graph`, reading a static
     (K, B, ...) input buffer (one leaf, or the four leaves of a
     device_augment tuple) and writing a static (metrics, K) buffer.  The
     capture records and runs nothing: the state is where the warm-up left
     it;
  3. every later chunk of that shape is a `copy_` into the input buffer and
     one replay on the current stream; the metrics come back as a clone,
     since the next replay overwrites the buffer;
  4. (the loop's business) an epoch's remainder steps run through the eager
     single step, on the same tensors.

Capture needs a step that never reads a value back to the host and never
rebinds a state tensor: every state tensor, Adam's step count included
(ops/adam.py), is written in place.  What the capture sees, and why it is
safe:

  * `torch.autograd.grad(..., retain_graph=True)` runs inside it (whole-
    network capture; the warm-up on a side stream is the rule for it);
  * ops/nn.py toggles `torch.backends.cudnn.allow_tf32` around each
    convolution: a Python global read when the convolution is launched, so
    the captured launch keeps the setting it was captured with;
  * K1's ctypes launch (ops/preprocess.py) reads PyTorch's current stream
    at launch time, which during capture is the capture stream;
  * `crop_hflip_at` reads its offsets from the static buffer on the card
    (the loop checked them on the host before the copy).

A capture that fails (a host read, an op that cannot be captured) raises; it
never falls back to the eager loop.  A graph addresses the tensors of the
state it was captured on, so a call with another state raises too.

Launch counts: a kernel wrapper counts a launch when it queues it, and a
captured launch is queued once, at capture, while the card runs it at every
replay.  The runner keeps `captured` (launches counted at capture, which did
not run then) and `replayed` (launches the card ran in replays) for every
kernel counter (`counted()`: ops/bulge.py, ops/fused_nhwc.py,
ops/preprocess.py); `launches_run` turns the wrappers' counts into the
launches the card ran, for the CLI and for whoever drives a runner.

On a CPU state the runner is the Python loop over the single step
(`eager`), which the CPU tests pin to K single steps bit for bit.

Data parallel (`axis_name=mesh`, parallel/dp.py build_dp_multi_step): the
body is the cross-replica step, and the runner broadcasts rank 0's state
the first time it sees a state.  Under NCCL the collectives are captured
into the graph with the rest of the chunk: the warm-up chunk's collectives
(and the broadcast before it) create the communicator before the capture,
and ProcessGroupNCCL joins its own stream to the capture stream by events.
Gloo's collectives run on the host and cannot be captured, so a CUDA state
under gloo raises instead of running the chunk eagerly.
"""

from __future__ import annotations

import torch

from ..ops import bulge, fused_nhwc, preprocess
from ..parallel.dp import Replicas
from .step import build_train_step

# every kernel wrapper's launch counter ({kernel: launches queued})
COUNTERS = (bulge.launches, fused_nhwc.launches, preprocess.launches)


def counted():
    """Every kernel wrapper's count now, as one dict."""
    return {k: n for c in COUNTERS for k, n in c.items()}


def launches_run(counted, runner=None, since=None):
    """{kernel: launches the card ran} for the kernels of `counted`, the
    wrappers' counts over a run: each counted launch, less those counted at
    a capture (which did not run then), plus those that `runner`'s replays
    ran in that run.  since: runner.stats() at the run's start (None: the
    run began when the runner was built)."""
    if runner is None:
        return dict(counted)
    now = runner.stats()
    was = since or {"captured": {}, "replayed": {}}
    return {k: n - now["captured"].get(k, 0) + was["captured"].get(k, 0)
            + now["replayed"].get(k, 0) - was["replayed"].get(k, 0)
            for k, n in counted.items()}


class _Graph:
    """One chunk shape's capture: the state it addresses, its static input
    leaves, the graph and its static (metrics, K) output."""

    def __init__(self, state, static_in, graph, names, static_out,
                 per_replay):
        self.state = state
        self.static_in = static_in
        self.graph = graph
        self.names = names
        self.static_out = static_out
        self.per_replay = per_replay     # {kernel counter: launches}


class MultiStep:
    """multi_step(state, hr_batches) -> (state, stacked_metrics).

    hr_batches: (K, B, C, H, W) — K consecutive batches on the state's
    device; under cfg.device_augment a tuple of such leaves, (K, B, ...)
    each.  stacked_metrics: dict of (K,) tensors (per-step losses, reference
    log-line fields preserved).  The state is updated in place and returned.
    """

    def __init__(self, cfg, **step_kw):
        self.step = build_train_step(cfg, **step_kw)
        self.mesh = step_kw.get("axis_name")
        self._replicas = None if self.mesh is None else Replicas(self.mesh)
        self._graphs = {}
        self._side = None
        self.replays = 0
        self.captured = dict.fromkeys(counted(), 0)
        self.replayed = dict.fromkeys(counted(), 0)

    def eager(self, state, hr_batches):
        """The K steps as a Python loop over the single step: the CPU path,
        a chunk's warm-up on the card, and the eager yardstick."""
        per_step = []
        tup = isinstance(hr_batches, tuple)
        for j in range((hr_batches[0] if tup else hr_batches).shape[0]):
            hr = tuple(x[j] for x in hr_batches) if tup else hr_batches[j]
            state, metrics = self.step(state, hr)
            per_step.append(metrics)
        return state, {k: torch.stack([m[k] for m in per_step])
                       for k in per_step[0]}

    @property
    def captures(self):
        return len(self._graphs)

    def stats(self):
        """What the graphs did, for a launch line: captures, replays and
        the kernel launches counted at capture / run in replays (kernels
        with none left out)."""
        return {"captures": self.captures, "replays": self.replays,
                "captured": {k: n for k, n in self.captured.items() if n},
                "replayed": {k: n for k, n in self.replayed.items() if n}}

    def __call__(self, state, hr_batches):
        if self._replicas is not None:
            self._replicas(state)
        if state.g.device.type != "cuda":
            return self.eager(state, hr_batches)
        if self.mesh is not None and self.mesh.backend != "nccl":
            raise RuntimeError(
                f"a CUDA graph cannot hold {self.mesh.backend} collectives "
                "(they run on the host): a data-parallel K-step chunk on "
                "the card needs the NCCL backend")
        leaves = hr_batches if isinstance(hr_batches, tuple) else (hr_batches,)
        key = tuple((tuple(x.shape), x.dtype, x.device) for x in leaves)
        g = self._graphs.get(key)
        if g is None:
            return self._warm_up_and_capture(key, state, hr_batches, leaves)
        if g.state is not state:
            raise ValueError("this runner's CUDA graph was captured on "
                             "another TrainState; build a runner per state")
        for s, x in zip(g.static_in, leaves):
            s.copy_(x)
        g.graph.replay()
        self.replays += 1
        for k, n in g.per_replay.items():
            self.replayed[k] += n
        out = g.static_out.clone()
        return state, {k: out[i] for i, k in enumerate(g.names)}

    def _warm_up_and_capture(self, key, state, hr_batches, leaves):
        dev = leaves[0].device
        cur = torch.cuda.current_stream(dev)
        if self._side is None:
            self._side = torch.cuda.Stream(dev)
        self._side.wait_stream(cur)
        with torch.cuda.stream(self._side):
            state, stacked = self.eager(state, hr_batches)
        cur.wait_stream(self._side)

        static_in = tuple(x.clone() for x in leaves)
        chunk = static_in if isinstance(hr_batches, tuple) else static_in[0]
        graph = torch.cuda.CUDAGraph()
        before = counted()
        try:
            with torch.cuda.graph(graph):
                _, out = self.eager(state, chunk)
                names = tuple(out)
                static_out = torch.stack([out[k] for k in names])
        except Exception as e:
            raise RuntimeError(
                "capturing a K-step chunk into a CUDA graph failed (the step "
                "must not read a value back or use an op that a graph cannot "
                "hold); the runner does not fall back to the eager loop"
            ) from e
        per_replay = {k: n - before[k] for k, n in counted().items()}
        for k, n in per_replay.items():
            self.captured[k] += n
        self._graphs[key] = _Graph(state, static_in, graph, names,
                                   static_out, per_replay)
        return state, stacked


def build_multi_step(cfg, **step_kw):
    """A `MultiStep` runner for cfg (step_kw: build_train_step's)."""
    return MultiStep(cfg, **step_kw)
