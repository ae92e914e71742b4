"""The port's trainer on image files and its end-of-run eval and sample
dumps, as a user starts them (`dcgan_sr_tpu_torch.cli.main` with `--cpu`,
ngf 4 / ndf 8 / batchSize 4 from the environment): the folder route with the
device-side crop and preprocess, the indexed route (Python and native
decoders), the textured fixture set, `--eval` and `--samples-dir`.  Image
files are written with PIL from a seed into temporary directories."""

import os
import re

import numpy as np
import pytest
from PIL import Image

from dcgan_sr_tpu_torch import cli
from dcgan_sr_tpu_torch.data import native

import torch_threads  # noqa: F401

ENV = {"ngf": "4", "ndf": "8", "batchSize": "4", "nThreads": "2"}
REF_LINE = re.compile(r"^\[(Train|Test)-set\] (PSNR|SSIM) btwn real_none & "
                      r"(real_bilinear|fake_none|fake_none_overlap): "
                      r"(\d+\.\d{8}), train-Size: (\d+)$")


@pytest.fixture
def run(monkeypatch, capsys):
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("DATA_ROOT", raising=False)

    def go(*args):
        capsys.readouterr()
        st = cli.main(["--cpu", "--steps", "2", "--epochs", "1", "--seed",
                       "1", *args])
        return st, capsys.readouterr().out.splitlines()
    return go


def _jpegs(d, names, hw, seed):
    rng = np.random.RandomState(seed)
    os.makedirs(d, exist_ok=True)
    for name in names:
        base = (rng.rand(hw[0] // 8, hw[1] // 8, 3) * 255).astype(np.uint8)
        Image.fromarray(base).resize((hw[1], hw[0]), Image.BILINEAR).save(
            os.path.join(d, name), quality=90)


def _ref_lines(out):
    return [REF_LINE.match(line) for line in out if line.startswith("[")]


def _pngs(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".png"))


def test_eval_and_samples_gray3(run, tmp_path):
    st, out = run("--config", "gray-3", "--textured", "--eval",
                  "--eval-sets", "1", "--samples-dir", str(tmp_path))
    lines = _ref_lines(out)
    assert all(lines) and len(lines) == 8
    assert [(m.group(1), m.group(3)) for m in lines[:2]] == [
        ("Train", "real_bilinear"), ("Train", "fake_none")]
    assert {m.group(5) for m in lines} == {"4"}
    assert _pngs(tmp_path) == ["fake_none_sample.png",
                               "real_bilinear_sample.png",
                               "real_none_sample.png",
                               "real_reduced_sample.png"]
    assert any(line.startswith("PSNR btwn real & fake: ") for line in out)
    assert out[-1].startswith("kernel launches: ")


def test_eval_and_samples_overlap(run, tmp_path):
    st, out = run("--config", "gray-patch-batch-overlap", "--synthetic",
                  "--eval", "--eval-sets", "1", "--g-ema", "0.9",
                  "--samples-dir", str(tmp_path))
    lines = out[[i for i, ln in enumerate(out) if ln.startswith("[")][0]:]
    tags = [ln.split("]")[0] + "]" for ln in lines if ln.startswith("[")]
    assert tags == ["[Train-set]"] * 6 + ["[Test-set]"] * 6 + \
        ["[Test-set-EMA]"] * 6
    assert sum("fake_none_overlap:" in ln for ln in lines) == 6
    assert "fake_none_overlap_sample.png" in _pngs(tmp_path)


def test_folder_route_with_device_augment(run, tmp_path):
    _jpegs(str(tmp_path / "faces" / "a"), [f"{i}.jpg" for i in range(6)],
           (218, 178), seed=1)
    st, out = run("--config", "gray", "--data-root", str(tmp_path / "faces"),
                  "--device-augment", "--scan", "2", "--eval",
                  "--samples-dir", str(tmp_path / "s"))
    assert "device_augment=True" in out[0] and "device_preprocess=True" in out[0]
    assert "Creating train metadata" in out
    assert "eval requires an indexed/synthetic loader" in out
    assert st.g_opt["t"] == 2
    assert "real_none_color_sample.png" in _pngs(tmp_path / "s")


def test_folder_route_with_device_preprocess_in_rgb(run, tmp_path):
    _jpegs(str(tmp_path / "imgs"), [f"{i}.png" for i in range(3)], (80, 96),
           seed=2)
    st, out = run("--config", "rgb-full", "--data-root", str(tmp_path / "imgs"),
                  "--device-preprocess", "--feed-bf16")
    assert st.g_opt["t"] == 2
    assert not any("not found" in line for line in out)


def test_indexed_route_turns_the_raw_feed_off(run, tmp_path):
    _jpegs(str(tmp_path), [f"{n:06d}.jpg" for n in range(1, 9)], (109, 89),
           seed=3)
    st, out = run("--config", "gray-3", "--data-root", str(tmp_path),
                  "--device-preprocess")
    assert ("device_augment/device_preprocess need the folder data path; "
            "disabled for this run") in out
    assert st.g_opt["t"] == 2


def test_textured_source_trains(run):
    st, out = run("--config", "gray-2", "--textured")
    assert st.g_opt["t"] == 2 and not any("not found" in ln for ln in out)


def test_native_loader(run, tmp_path):
    if not native.available():
        pytest.skip(f"the committed native library does not load: "
                    f"{native.load_error()}")
    _jpegs(str(tmp_path), [f"{n:06d}.jpg" for n in range(1, 9)], (109, 89),
           seed=4)
    st, out = run("--config", "gray-3", "--data-root", str(tmp_path),
                  "--native-loader", "--samples-dir", str(tmp_path / "s"))
    assert "using native C++ indexed loader" in out
    assert st.g_opt["t"] == 2 and _pngs(tmp_path / "s")
