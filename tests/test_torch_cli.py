"""The port's trainer as a user starts it, on the CPU at ngf 4 / ndf 8 from
the environment: `python -m dcgan_sr_tpu_torch.cli --cpu ...` trains, logs
reference-shaped lines, writes both checkpoints and resumes; and the loop
(train/loop.py) chunks and logs as the JAX package's does."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from dcgan_sr_tpu.utils.logging import MetricsLogger as JMetricsLogger
from dcgan_sr_tpu_torch import cli
from dcgan_sr_tpu_torch.core import get_config
from dcgan_sr_tpu_torch.train.loop import train_epochs
from dcgan_sr_tpu_torch.train.step import init_train_state
from dcgan_sr_tpu_torch.utils.logging import MetricsLogger
from dcgan_sr_tpu_torch.utils.timers import Timer

import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOG_LINE = re.compile(
    r"^Epoch: \[(\d+)\]\[ *(\d+) / *(\d+)\]\t Time: [\d.]+  DataTime: [\d.]+  "
    r"  Err_G: ([\d.]+)  Err_D: ([\d.]+)$")
KW = dict(env_override=False, ngf=4, ndf=8, batchSize=4)


def _cli(args, timeout=300):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update({"ngf": "4", "ndf": "8", "batchSize": "4"})
    return subprocess.run(
        [sys.executable, "-m", "dcgan_sr_tpu_torch.cli", "--cpu", *args],
        capture_output=True, text=True, timeout=timeout, cwd=REPO, env=env)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("ck"))
    jl = os.path.join(ck, "metrics.jsonl")
    r = _cli(["--config", "gray-3", "--synthetic", "--steps", "3", "--scan",
              "2", "--epochs", "1", "--seed", "1", "--checkpoint-dir", ck,
              "--metrics-jsonl", jl])
    assert r.returncode == 0, r.stderr[-3000:]
    return ck, jl, r.stdout.splitlines()


def test_cli_trains_and_logs_reference_lines(trained):
    _, _, lines = trained
    assert lines[0].startswith("config: Config(variant='gray-3'")
    assert "ngf=4" in lines[0] and "batchSize=4" in lines[0]
    assert lines[1] == "Random Seed: 1"
    steps = [LOG_LINE.match(l) for l in lines if l.startswith("Epoch:")]
    # 3 steps at --scan 2: one chunk of two (logged at its end), one single
    assert [(m.group(1), m.group(2), m.group(3)) for m in steps] == [
        ("1", "1", "3"), ("1", "2", "3")]
    for m in steps:
        assert np.isfinite(float(m.group(4))) and np.isfinite(float(m.group(5)))
    assert any(l.startswith("End of epoch 1 / 1 \t Time Taken: ") for l in lines)
    assert lines[-2].startswith("Total time: ")


def test_cli_last_line_counts_kernel_launches(trained):
    _, _, lines = trained
    assert lines[-1].startswith("kernel launches: ")
    counts = json.loads(lines[-1][len("kernel launches: "):])
    # on the CPU every wrapper runs its plain version: nothing is launched
    assert counts == {"bulge_stats": 0, "bulge_main": 0, "bulge_stats_bf16": 0,
                      "bulge_main_bf16": 0, "preprocess": 0}


def test_cli_writes_checkpoints_and_jsonl(trained):
    ck, jl, _ = trained
    name = get_config("gray-3", env_override=False).name
    assert {f"{name}_1_net_G.npz", f"{name}_1_net_D.npz"} <= set(os.listdir(ck))
    recs = [json.loads(l) for l in open(jl)]
    assert [r["step"] for r in recs] == [1, 2]
    assert {"errG", "errD", "errD_real_reported", "pixel_loss"} <= set(recs[0])
    with np.load(os.path.join(ck, f"{name}_1_net_G.npz")) as data:
        assert int(data["_opt_/_t_"]) == 3


def test_cli_resumes_at_the_next_epoch(trained):
    ck, _, _ = trained
    r = _cli(["--config", "gray-3", "--synthetic", "--steps", "2", "--epochs",
              "2", "--seed", "1", "--checkpoint-dir", ck, "--resume",
              "--log-every", "2"])
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.splitlines()
    assert "resumed from epoch 1" in lines
    steps = [LOG_LINE.match(l) for l in lines if l.startswith("Epoch:")]
    assert [(m.group(1), m.group(2)) for m in steps] == [("2", "1")]
    name = get_config("gray-3", env_override=False).name
    with np.load(os.path.join(ck, f"{name}_2_net_G.npz")) as data:
        assert int(data["_opt_/_t_"]) == 5


def test_cli_without_a_card_and_without_cpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="--cpu"):
        cli.main(["--config", "gray-3", "--synthetic", "--steps", "1"])


def test_cli_falls_back_to_synthetic_with_the_reference_message(capsys):
    cfg = get_config("gray-3", **KW)
    args = type("A", (), {"synthetic": False})()
    _, batch_fn = cli.build_data(cfg, args)
    assert "indexed CelebA not found at" in capsys.readouterr().out
    assert batch_fn(1, 0).shape == (4, 1, 64, 64)


def test_cli_pm1_variants_feed_pm1_batches():
    cfg = get_config("gray", **KW)
    _, batch_fn = cli.build_data(cfg, type("A", (), {"synthetic": True})())
    hr = batch_fn(1, 0)
    assert hr.dtype == np.float32 and hr.min() == -1.0 and hr.max() == 1.0


@pytest.mark.parametrize("flag", ["--fast-ops", "--dp", "--use-pallas"])
def test_cli_has_no_flags_of_unported_options(flag, capsys):
    """--use-pallas has no counterpart (the port's step always runs K1): it
    is not a flag.  --fast-ops and --dp are ported and listed
    (tests/test_torch_fast_ops.py, test_torch_compact.py,
    test_torch_dp.py)."""
    with pytest.raises(SystemExit) as e:
        cli.main(["--help"] if flag != "--use-pallas" else ["--cpu", flag])
    if flag != "--use-pallas":
        assert e.value.code == 0
        out = capsys.readouterr().out
        assert flag in out
        if flag == "--dp":
            assert "data-parallel over all local devices" in \
                " ".join(out.split())
    else:
        assert e.value.code == 2


def test_cli_patch_variants_say_not_ported(tmp_path, monkeypatch, capsys):
    """The patch variants' batches are ported (test_torch_bf16_step.py holds
    them to the JAX CLI's), and so is the indexed loader: a route of real
    image files loads, and a patch variant trains a step on its tiles."""
    cfg = get_config("gray-patch", **KW)
    _, batch_fn = cli.build_data(cfg, type("A", (), {"synthetic": True})())
    assert batch_fn(1, 0).shape == (64, 1, 8, 8)  # one image's 8x8 grid
    write_celeba(tmp_path, range(1, 3))
    loader, batch_fn = cli.build_data(cfg, type(
        "A", (), {"synthetic": False, "data_root": str(tmp_path)})())
    try:
        assert type(loader).__name__ == "IndexedCelebA"
        assert batch_fn(1, 0).shape == (64, 1, 8, 8)   # file 000002.jpg
    finally:
        loader.close()
    for k, v in {"ngf": "4", "ndf": "8"}.items():
        monkeypatch.setenv(k, v)
    st = cli.main(["--cpu", "--config", "gray-patch", "--data-root",
                   str(tmp_path), "--steps", "1", "--epochs", "1", "--seed",
                   "1"])
    assert st.g_opt["t"] == 1
    assert "not found" not in capsys.readouterr().out


def write_celeba(route, nums, hw=(109, 89), seed=0):
    """CelebA-like %06d.jpg files of smooth random images."""
    from PIL import Image
    rng = np.random.RandomState(seed)
    for n in nums:
        base = (rng.rand(hw[0] // 8, hw[1] // 8, 3) * 255).astype(np.uint8)
        Image.fromarray(base).resize((hw[1], hw[0]), Image.BILINEAR).save(
            os.path.join(str(route), f"{n:06d}.jpg"), quality=90)


@pytest.mark.parametrize("steps,scan,log_every,want", [
    (5, 2, 1, [1, 3, 4]),       # two chunks of 2, then the remainder step
    (4, 1, 3, [2, 3]),          # every third step, and the epoch's last
    (3, 4, 1, [0, 1, 2]),       # a chunk larger than the epoch: single steps
])
def test_loop_chunks_and_log_cadence(steps, scan, log_every, want):
    cfg = get_config("gray-3", **KW)
    st = init_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    lines, asked = [], []

    def batch_fn(epoch, i):
        asked.append(i)
        return np.random.RandomState(i).rand(4, 1, 64, 64).astype(np.float32)

    st, last = train_epochs(cfg, st, batch_fn, niter=1, steps_per_epoch=steps,
                            log_fn=lines.append, log_every=log_every,
                            scan_steps=scan)
    assert asked == list(range(steps))
    got = [int(LOG_LINE.match(l).group(2)) for l in lines if l.startswith("Epoch:")]
    assert got == want
    assert st.g_opt["t"] == steps and np.isfinite(float(last["errG"]))


def test_loop_resume_numbering_and_default_steps(tmp_path):
    cfg = get_config("gray-3", ntrain=9, **KW)       # 9 images // 4 = 2 steps
    st = init_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    lines = []
    batch = lambda e, i: np.zeros((4, 1, 64, 64), np.float32) + 0.1 * i  # noqa: E731
    train_epochs(cfg, st, batch, niter=3, start_epoch=2, log_fn=lines.append,
                 checkpoint_dir=str(tmp_path))
    assert [l for l in lines if l.startswith("End of epoch")][0].startswith(
        "End of epoch 3 / 3")
    assert st.g_opt["t"] == 2
    assert sorted(os.listdir(tmp_path)) == [f"{cfg.name}_3_net_D.npz",
                                            f"{cfg.name}_3_net_G.npz"]


def test_profile_step_reports_host_time_on_the_cpu(tmp_path, capsys):
    from dcgan_sr_tpu_torch import profile_step
    trace = str(tmp_path / "trace.json")
    env = {"ngf": "4", "ndf": "8", "batchSize": "4"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        r = profile_step.main(["--cpu", "--steps", "2", "--trace", trace])
    finally:
        for k, v in old.items():
            os.environ.pop(k) if v is None else os.environ.__setitem__(k, v)
    assert r["steps"] == 2 and r["step_ms"] > 0
    assert r["device_busy_share"] is None and r["device_top"] == []
    assert any("convolution" in name for name, _, _ in r["host_top"])
    assert os.path.getsize(trace) > 0
    out = capsys.readouterr().out
    assert "gray-3 batch (4, 1, 64, 64) on cpu: step " in out


def test_timer_and_logger(tmp_path):
    t = Timer()
    t.stop()
    a = t.time()["real"]
    assert a >= 0 and t.time()["real"] == a
    assert t.resume().stop().time()["real"] >= a
    assert t.reset().time()["real"] < 1.0
    lines = []
    path = str(tmp_path / "m.jsonl")
    lg = MetricsLogger(jsonl_path=path, log_fn=lines.append)
    lg.log_step(2, 7, 10, 0.5, 0.25, {"errG": 1.5, "errD": 0.75})
    lg.log_epoch(2, 5, 3.0)
    lg.close()
    assert lines[0] == ("Epoch: [2][       7 /       10]\t Time: 0.500  "
                        "DataTime: 0.250    Err_G: 1.5000000000000000  "
                        "Err_D: 0.7500")
    assert lines[1] == "End of epoch 2 / 5 \t Time Taken: 3.000"
    want = []
    jl = JMetricsLogger(log_fn=want.append)
    jl.log_step(2, 7, 10, 0.5, 0.25, {"errG": 1.5, "errD": 0.75})
    jl.log_epoch(2, 5, 3.0)
    assert lines == want            # the JAX package's lines, to the byte
    rec = json.loads(open(path).read())
    assert rec["epoch"] == 2 and rec["step"] == 7 and rec["errG"] == 1.5
