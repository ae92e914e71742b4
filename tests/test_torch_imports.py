"""The port imports nothing of JAX and nothing of the JAX package: every
module of dcgan_sr_tpu_torch, imported in a fresh interpreter, leaves
neither `jax` nor `dcgan_sr_tpu` in sys.modules; chip_smoke.py names
neither in its imports; and chip_smoke.py refuses to run without a card."""

import ast
import json
import os
import pkgutil
import subprocess
import sys

import pytest

import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "dcgan_sr_tpu")


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _port_modules():
    import dcgan_sr_tpu_torch
    return ["dcgan_sr_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(dcgan_sr_tpu_torch.__path__,
                                              "dcgan_sr_tpu_torch.")]


def test_port_modules_import_no_jax():
    mods = _port_modules()
    # the list comes from walking the package, so a new module is covered
    # the moment it exists
    for m in ("ops.bulge", "ops.preprocess", "ops._build", "ops.adam",
              "losses.schemes", "train.step", "train.multi_step",
              "train.loop", "train.checkpoint", "data.synthetic",
              "utils.timers", "utils.logging", "serve", "cli", "upscale",
              "image.patches", "infer.seam", "infer.seam_device",
              "infer.ensemble", "infer.tiled", "ops.fused_nhwc",
              "ops.fused_nhwc_mma", "ops.fused_nhwc_wgmma",
              "bench_fused", "bench_infer", "metrics.psnr_ssim",
              "utils.stats", "image.io", "image.ops", "data.folder",
              "data.indexed", "data.prefetch", "data.native", "data.dispatch",
              "evaluation.harness", "compat.t7", "compat.torch_import",
              "compat.torch_export", "ops.fast", "ops.compact",
              "utils.measure", "select_checkpoint", "overlap_protocol",
              "validate_bf16", "zssr_photo", "serve_load", "loader_bench",
              "quality_protocol", "bench", "attr_variant", "attr_overlap",
              "feed_ab", "probe_image_io", "profile_table", "utils.host",
              "ops.bn"):
        assert "dcgan_sr_tpu_torch." + m in mods
    code = ("import importlib, json, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    loaded = json.loads(r.stdout.splitlines()[-1])
    assert [m for m in loaded if _forbidden(m)] == []


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("rel", ["chip_smoke.py"] + sorted(
    os.path.relpath(os.path.join(d, f), REPO)
    for d, _, fs in os.walk(os.path.join(REPO, "dcgan_sr_tpu_torch"))
    for f in fs if f.endswith(".py")))
def test_no_jax_import_statements(rel):
    bad = [m for m in _imports(os.path.join(REPO, rel)) if _forbidden(m)]
    assert bad == [], f"{rel} imports {bad}"


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Here (no CUDA device) and alone in a directory, chip_smoke exits
    non-zero and prints no result line."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    for script, cwd in ((os.path.join(REPO, "chip_smoke.py"), REPO),
                        (str(lone), str(tmp_path))):
        r = subprocess.run([sys.executable, script], cwd=cwd,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
