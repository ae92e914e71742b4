"""The port's feed A/B (python -m dcgan_sr_tpu_torch.feed_ab) and image
round-trip probe (.probe_image_io) against the JAX tools, on the CPU: the
A/B prints the JAX tool's lines in ABBA order, and the probe writes the
JAX tool's PNG bytes and prints its lines."""

import contextlib
import functools
import io
import os
import re

import numpy as np
import pytest

import dcgan_sr_tpu.train as JT
from dcgan_sr_tpu.data import native as j_native
from dcgan_sr_tpu.image.io import load_image as j_load_image
from dcgan_sr_tpu.train import multi_step as JMS
from dcgan_sr_tpu_torch import feed_ab, probe_image_io
from dcgan_sr_tpu_torch.train.multi_step import counted
from tools import feed_ab as j_feed_ab
from tools import probe_image_io as j_probe

import torch_threads  # noqa: F401

NUMBER = re.compile(r"\d+(\.\d+)?")
ARGS = ["--cpu", "--config", "gray-3", "--steps", "2", "--scan", "2",
        "--rounds", "2"]


def _run(main, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(*args)
    return buf.getvalue().splitlines()


def _skeleton(lines):
    """The tool's own lines (not the train loop's), numbers blanked."""
    return [NUMBER.sub("#", l) for l in lines
            if not l.startswith(("Epoch:", "End of epoch"))]


@pytest.mark.parametrize("flags", [[], ["--feed-bf16"]])
def test_feed_ab_prints_the_jax_tools_lines_in_abba_order(monkeypatch,
                                                          flags):
    monkeypatch.setenv("ngf", "4")
    monkeypatch.setenv("ndf", "8")
    monkeypatch.setenv("batchSize", "2")
    ran = {}
    lines = _run(functools.partial(feed_ab.main, launches=ran), ARGS + flags)
    # every kernel's launches that ran over the epochs: none on the CPU
    assert ran == dict.fromkeys(counted(), 0)
    # the JAX tool's lines, its train loop and programs replaced by stubs
    # that return at once (nothing compiles)
    monkeypatch.setattr(JT, "train_epochs", lambda cfg, state, *a, **k: (
        state, {"errG": 0.5}))
    monkeypatch.setattr(JT, "init_train_state", lambda cfg, key: None)
    monkeypatch.setattr(JT, "build_train_step", lambda cfg: lambda s, b: s)
    monkeypatch.setattr(JMS, "jit_multi_step", lambda cfg: None)
    want = _run(j_feed_ab.main, ARGS + flags)
    assert _skeleton(lines) == _skeleton(want)
    own = [l for l in lines if l.startswith("round ")]
    assert [l.split(":")[0] for l in own] == [
        "round 0 stage_ahead=False", "round 0 stage_ahead=True",
        "round 1 stage_ahead=True", "round 1 stage_ahead=False"]
    assert re.fullmatch(r"stage_ahead=True won [0-2]/2 paired rounds",
                        lines[-1])
    # each epoch ran its 2 steps as one K = 2 chunk and logged it
    assert sum(l.startswith("Epoch: [1][") for l in lines) == 5


def test_probe_image_io_writes_the_jax_tools_pngs(monkeypatch, tmp_path):
    """Byte for byte against the JAX tool's PIL encoder (its native
    encoder, where native/libdcgansr.so loads, writes other bytes of the
    same pixels, checked too)."""
    port_dir, jax_dir, native_dir = (tmp_path / d for d in
                                     ("port", "jax", "native"))
    got = _run(probe_image_io.main, [str(port_dir)])

    def jax_tool(out):
        os.makedirs(out, exist_ok=True)
        print("== tensor -> image (display-normalized save) ==")
        j_probe.probe_tensor_to_image(out)
        print("== image -> tensor (byte decode) ==")
        j_probe.probe_image_to_tensor(out)

    native_lines = _run(jax_tool, str(native_dir))
    monkeypatch.setattr(j_native, "save_available", lambda: False)
    want = _run(jax_tool, str(jax_dir))
    assert got == want == native_lines
    names = sorted(os.listdir(jax_dir))
    assert sorted(os.listdir(port_dir)) == names and len(names) == 9
    for name in names:
        assert (port_dir / name).read_bytes() == (jax_dir / name).read_bytes()
        np.testing.assert_array_equal(
            j_load_image(str(port_dir / name), dtype="byte"),
            j_load_image(str(native_dir / name), dtype="byte"))
    assert "constant input -> black" in "\n".join(got)
