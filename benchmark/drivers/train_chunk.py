"""The trainer's K-step chunk (train/multi_step.py), calls back to back.

Set-up builds one TrainState from the benchmark's weights and one runner,
and drives them through the runner's first two calls: the first runs the K
steps eagerly and captures them into a CUDA graph, the second is the first
replay.  Both are the window's own call on its own feed (super-batches
made on the device from the seed, cycled), and that same state and runner
are handed to the window, whose every call is one graph replay.  The state
before and after the first replay is kept for the check.

The check (after the window, the program's state freed) reads, against
the reference from the same weights and rows:
  grad1_flip_share_D  of the eager call: the share of D's parameter
                      elements whose first gradient, as Adam's first moment
                      holds it after step 1, has the other sign than the
                      reference's (Adam's first step moves each element by
                      lr times that sign);
  change3_gap         of the eager call: the worst leaf's gap of norms of
                      the parameters' change over the first steps;
  chunk_change_gap    of the first replay: the worst leaf's gap of norms of
                      the parameters' change over its K steps, against the
                      reference's K steps from the state before it on the
                      same super-batch (a replay that leaves the state
                      unchanged reads 1);
leaves whose reference gradient (the first of the steps followed) is under
a thousandth of its network's median leaf's are left out of the changes
(change3_left_out, chunk_change_left_out count them).  Printed beside them
and held to no limit: G's share and mass of the first gradient (G holds
under 1% of the elements, and many of them have gradients near nought,
whose signs round either way), D's mass, the same of both changes, the
worst leaf's gap of the first gradient (grad1_gap), the median and D's
worst leaves' gaps, the worst leaves' names, and the losses of the eager steps (loss1_gap, loss_gap) and of the
replay's first steps (replay_loss1_gap, replay_loss_gap).  The cell's file
says which numbers are compared; PERF.md gives the readings behind the
choice.
"""

from __future__ import annotations

import torch

from .. import flops as F
from ..common import leaf_gaps, queued_calls
from ..reference import train_step as R
from ..stats import rate
from ..weights import draw, generator_for

LOSSES = ("errD_real", "errD_fake", "errG")


def flips(prog, ref):
    """(share, mass): the share of the leaves' elements whose sign differs
    between the program's and the reference's, and the share of the
    reference's magnitude that those elements carry.  Adam's first step
    moves each element by lr times the sign of its gradient, so the share
    is that of the update that goes the wrong way, and the first-order gain
    of that step is (1 - 2 mass) of the reference's."""
    n = flipped = 0
    mass = flipped_mass = 0.0
    for p, r in zip(prog, ref):
        wrong = (p > 0) != (r > 0)
        size = r.abs().double()
        n += r.numel()
        flipped += int(wrong.sum())
        mass += float(size.sum())
        flipped_mass += float(size[wrong].sum())
    return flipped / n, flipped_mass / max(mass, 1e-300)


class Driver:
    def __init__(self, cell):
        self.cell = cell
        t = cell.traffic
        self.k, self.batch = t["steps_per_call"], t["batch"]
        self.n_super, self.check_steps = t["super_batches"], t["check_steps"]
        self.trace_calls = t["trace_calls"]
        c = cell.config
        self.hr_hw = c["fineSize"]
        self.flops_per_image = F.train_step_flops(
            cell.g_spec, cell.d_spec, self.hr_hw // 2, self.hr_hw)

    # -- set-up ----------------------------------------------------------

    def setup(self):
        from dcgan_sr_tpu_torch.models import Network, discriminator_spec, \
            generator_spec
        from dcgan_sr_tpu_torch.ops.adam import adam_init
        from dcgan_sr_tpu_torch.train.multi_step import build_multi_step
        from dcgan_sr_tpu_torch.train.step import TrainState, params_of

        from ..weights import port_trees

        cell, dev = self.cell, self.cell.device
        cfg = cell.port_config(batchSize=self.batch)
        self.cfg = cfg
        cell.check_port_specs(cfg)
        self.images_per_step = cfg.images_consumed_per_step
        gen = generator_for(cell.seed, dev, 0)
        self.g0 = draw(cell.g_spec, gen, dev)
        self.d0 = draw(cell.d_spec, gen, dev)
        g = Network(generator_spec(cfg), *port_trees(self.g0), device=dev,
                    fuse=False, trainable=True)
        d = Network(discriminator_spec(cfg), *port_trees(self.d0),
                    device=dev, fuse=False, trainable=True)
        self.state = TrainState(g=g, d=d, g_opt=adam_init(params_of(g)),
                                d_opt=adam_init(params_of(d)))
        data_gen = generator_for(cell.seed, dev, 1)
        shape = (self.k, self.batch, cell.config["nc"], self.hr_hw,
                 self.hr_hw)
        self.data = [torch.rand(shape, generator=data_gen, device=dev)
                     for _ in range(self.n_super)]
        self.runner = build_multi_step(cfg)
        self._params_of = params_of

        # call 1: eager K steps and the capture; the first steps observed
        seen = {}
        step = self.runner.step
        count = [0]

        def observed(state, hr, *a, **kw):
            state, m = step(state, hr, *a, **kw)
            count[0] += 1
            if count[0] == 1:
                seen["m1"] = [t.detach().clone() for t in
                              state.g_opt["m"] + state.d_opt["m"]]
            if count[0] == self.check_steps:
                seen["p"] = [t.detach().clone() for t in
                             params_of(state.g) + params_of(state.d)]
            return state, m

        self.runner.step = observed
        try:
            _, m = self.runner(self.state, self.data[0])
        finally:
            self.runner.step = step
        self.first = {k: m[k][:self.check_steps].float().cpu()
                      for k in LOSSES}
        self.seen = seen
        # the state the eager chunk left, call 2 (the first replay), and
        # the parameters it left
        self.s20 = self._snapshot()
        _, m = self.runner(self.state, self.data[1 % self.n_super])
        self.replay = {k: m[k][:self.check_steps].float().cpu()
                       for k in LOSSES}
        self.s40 = [t.detach().clone() for t in
                    params_of(self.state.g) + params_of(self.state.d)]
        self.bad = torch.zeros((), dtype=torch.int64, device=dev)
        self._refs = {}

    def _snapshot(self):
        st, p = self.state, self._params_of
        cl = lambda ts: [t.detach().clone() for t in ts]  # noqa: E731
        return {"g": cl(p(st.g)), "d": cl(p(st.d)),
                "g_m": cl(st.g_opt["m"]), "g_v": cl(st.g_opt["v"]),
                "d_m": cl(st.d_opt["m"]), "d_v": cl(st.d_opt["v"]),
                "t": int(st.g_opt["t"])}

    # -- the window ------------------------------------------------------

    def window(self):
        cell = self.cell

        def call(i):
            _, m = self.runner(self.state, self.data[(2 + i) % self.n_super])
            losses = torch.stack([m[k] for k in LOSSES])
            self.bad += (~torch.isfinite(losses)).any(0).sum()

        n, secs = queued_calls(call, cell.seconds, cell.device, cell.tracer,
                               trace_start=1, trace_calls=self.trace_calls)
        steps = n * self.k
        images = steps * self.images_per_step
        return {
            "metrics": {"train_images_per_s": rate(images, secs)},
            "attempted": steps, "failed": int(self.bad),
            "work": {"flops": self.trace_calls * self.k * self.batch
                     * self.flops_per_image},
            "notes": {"calls": n, "window_s": secs,
                      "flops_per_image": self.flops_per_image,
                      "graph": self.runner.stats()},
        }

    def release(self):
        del self.state, self.runner, self.data[2:]

    # -- the check ---------------------------------------------------------

    def _ref_state(self, snap=None):
        if snap is None:
            return R.init_state(self.g0, self.d0)
        st = R.init_state(self.g0, self.d0)
        for tag in ("g", "d"):
            for dst, src in zip(R.leaves(st[tag]), snap[tag]):
                dst.copy_(src)
            st["adam"][tag]["m"] = [t.clone() for t in snap[tag + "_m"]]
            st["adam"][tag]["v"] = [t.clone() for t in snap[tag + "_v"]]
        st["adam"]["t"] = snap["t"]
        return st

    def _follow(self, rows, precision="fp32", snap=None, batch_rows=None,
                steps=None, config=None):
        """The reference over the first `steps` steps of `rows` (the check's
        steps by default) from the initial weights or from a snapshot of the
        program's state: (losses {name: [..]}, the first step's gradient
        leaves, the parameters' change leaves)."""
        st = self._ref_state(snap)
        p0 = [t.clone() for t in R.leaves(st["g"]) + R.leaves(st["d"])]
        adam = lambda: st["adam"]["g"]["m"] + st["adam"]["d"]["m"]  # noqa
        m0 = [t.clone() for t in adam()]
        losses = {k: [] for k in LOSSES}
        grad = None
        b1 = self.cell.config["beta1"]
        for j in range(steps or self.check_steps):
            out = R.step(st, rows[j], self.cell.g_spec, self.cell.d_spec,
                         config or self.cell.config, precision, batch_rows)
            for k in LOSSES:
                losses[k].append(out[k])
            if j == 0:
                grad = [(m - b1 * a) / (1 - b1) for m, a in zip(adam(), m0)]
        change = [a - b for a, b in zip(R.leaves(st["g"]) + R.leaves(st["d"]),
                                        p0)]
        return losses, grad, change

    def _ref(self, key, *args, **kw):
        """`_follow(*args, **kw)`, kept under `key` for the next reading."""
        if key not in self._refs:
            self._refs[key] = self._follow(*args, **kw)
        return self._refs[key]

    def _split(self, leaves):
        ng = len(R.leaves(self.g0))
        return leaves[:ng], leaves[ng:]

    def _leaf_numbers(self, out, tag, prog, ref, ref_grad=None):
        """out[tag + ...]: the worst leaf's gap of norms (`_gap`, leaves
        whose reference gradient `ref_grad` is under a thousandth of its
        network's median leaf's left out, counted in `_left_out`), the
        median leaf's (`_median_gap`), the worst leaf's name, D's worst,
        and, for G and D apart, the share of elements whose sign flips
        and the share of the reference's magnitude they carry
        (`_flip_share_G`, `_flip_mass_G`, ...)."""
        names = (["G" + n for n in R.leaf_names(self.g0)],
                 ["D" + n for n in R.leaf_names(self.d0)])
        rows, d_worst, left_out = [], 0.0, 0
        for side, net in ((0, "G"), (1, "D")):
            p_, r_ = self._split(prog)[side], self._split(ref)[side]
            skip = None
            if ref_grad is not None:
                norms = [float(torch.linalg.vector_norm(t))
                         for t in self._split(ref_grad)[side]]
                med = sorted(norms)[len(norms) // 2]
                skip = [x < 1e-3 * med for x in norms]
                left_out += sum(skip)
            gaps = leaf_gaps(p_, r_, skip)
            rows += [(g, n) for g, n in zip(gaps, names[side])
                     if g is not None]
            if side == 1:
                d_worst = max(g for g in gaps if g is not None)
            share, mass = flips(p_, r_)
            out[f"{tag}_flip_share_{net}"] = share
            out[f"{tag}_flip_mass_{net}"] = mass
        rows.sort()
        out[tag + "_gap"] = rows[-1][0]
        out[tag + "_median_gap"] = rows[len(rows) // 2][0]
        out[tag + "_worst_leaf"] = rows[-1][1]
        out[tag + "_D_gap"] = d_worst
        if ref_grad is not None:
            out[tag + "_left_out"] = left_out

    @staticmethod
    def _loss_gaps(out, tag, losses, ref):
        out[tag + "1_gap"] = max(abs(losses[k][0] - ref[k][0])
                                 for k in LOSSES)
        out[tag + "_gap"] = max(abs(a - b) for k in LOSSES
                                for a, b in zip(losses[k], ref[k]))

    def readings(self, kind="program"):
        """The check's numbers: of the program ("program"), of the control
        (the reference in float8 in the program's place, "control"), or of
        a fault planted in the reference in the program's place
        ("fault_half": half the batch left out, the mean over the rest, in
        every step; "fault_stale": the replay trains on the super-batch
        its graph was captured with, the eager call sound; "fault_g_label":
        G trained towards the fake label, in every step)."""
        rows0, rows1 = self.data[0], self.data[1 % self.n_super]
        ref = self._ref("ref", rows0)
        chunk_ref = self._ref("chunk_ref", rows1, snap=self.s20,
                              steps=self.k)
        if kind == "program":
            losses = {k: self.first[k].tolist() for k in LOSSES}
            b1 = self.cell.config["beta1"]
            grad = [m / (1 - b1) for m in self.seen["m1"]]
            p0 = R.leaves(self.g0) + R.leaves(self.d0)
            side = (losses, grad,
                    [a - b for a, b in zip(self.seen["p"], p0)])
            s20 = self.s20["g"] + self.s20["d"]
            chunk = ({k: self.replay[k].tolist() for k in LOSSES}, None,
                     [a - b for a, b in zip(self.s40, s20)])
        elif kind == "control":
            side = self._follow(rows0, "fp8")
            chunk = self._follow(rows1, "fp8", self.s20, steps=self.k)
        elif kind == "fault_half":
            half = self.batch // 2
            side = self._follow(rows0, batch_rows=half)
            chunk = self._follow(rows1, snap=self.s20, batch_rows=half,
                                 steps=self.k)
        elif kind == "fault_stale":
            side = ref
            chunk = self._follow(rows0, snap=self.s20, steps=self.k)
        elif kind == "fault_g_label":
            c = self.cell.config
            c = {**c, "g_label": c["fake_label"]}
            side = self._follow(rows0, config=c)
            chunk = self._follow(rows1, snap=self.s20, steps=self.k, config=c)
        else:
            raise ValueError(f"unknown reading kind {kind!r}")
        out = {}
        self._loss_gaps(out, "loss", side[0], ref[0])
        self._leaf_numbers(out, "grad1", side[1], ref[1])
        self._leaf_numbers(out, "change3", side[2], ref[2], ref[1])
        self._loss_gaps(out, "replay_loss",
                        {k: v[:self.check_steps] for k, v in chunk[0].items()},
                        {k: v[:self.check_steps]
                         for k, v in chunk_ref[0].items()})
        self._leaf_numbers(out, "chunk_change", chunk[2], chunk_ref[2],
                           chunk_ref[1])
        return out
