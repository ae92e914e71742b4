"""The harness finds a configuration, a cell and a per-layer metric by
name: added as new files and new entries in a copied tree, with no file
that was there edited, they run.  And the imports: nothing a run loads is
jax, jaxlib, flax or the JAX package (whole top-level names), and the
reference loads nothing of the program."""

import json
import os
import re
import shutil
import subprocess
import sys

from benchmark import harness

ROOT = harness.ROOT

NEW_METRIC = '''"""A count: the FLOPs of the traced stretch's calls."""


def read(ctx):
    return ctx.work.get("flops")
'''

RUN = r'''
import json, sys, time, torch
from benchmark import harness
over = json.loads(sys.argv[2])
code, res = harness.run(sys.argv[1], 5, 0.5, int(sys.argv[3]),
                        t_start=time.perf_counter(),
                        device=torch.device("cpu"), overrides=over)
print("LOADED", json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
sys.exit(code)
'''


def _copy_tree(dst):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))


def _run(cwd, name, overrides, trace, with_port=True):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.pathsep.join([cwd] + ([ROOT] if with_port
                                                 else []))
    return subprocess.run([sys.executable, "-c", RUN, name,
                           json.dumps(overrides), str(trace)], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=600)


def test_new_config_cell_and_metric_are_found_by_name(tmp_path):
    dst = str(tmp_path)
    _copy_tree(dst)
    here = os.path.join(dst, "benchmark")
    with open(os.path.join(here, "configs", "gray-3.json")) as f:
        conf = json.load(f)
    conf["name"] = "gray-3-again"
    with open(os.path.join(here, "configs", "gray-3-again.json"), "w") as f:
        json.dump(conf, f)
    with open(os.path.join(here, "workloads", "gray3-bulk-bf16.json")) as f:
        wl = json.load(f)
    wl.update(name="again-bulk", config="gray-3-again", traffic="bulk-again",
              why="a cell added as files")
    with open(os.path.join(here, "workloads", "again-bulk.json"), "w") as f:
        json.dump(wl, f)
    with open(os.path.join(here, "metrics", "flops_count.sr.py"), "w") as f:
        f.write(NEW_METRIC)
    with open(os.path.join(dst, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "gray-3-again", "source": "x",
                             "file": "benchmark/configs/gray-3-again.json",
                             "reduced": [], "why": "a copy"})
    bench["workloads"].append({"name": "again-bulk", "config": "gray-3-again",
                               "traffic": "bulk-again", "chips": 1,
                               "why": "a cell added as files"})
    for m in bench["end_to_end"]:
        if m["name"] == "sr_mp_per_s":
            m["workloads"].append("again-bulk")
    bench["per_layer"].append({"name": "flops_count.sr", "unit": "FLOP",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "SR pipeline",
                               "moves": "sr_mp_per_s",
                               "workloads": ["again-bulk"]})
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    over = {"config": {"ngf": 4},
            "traffic_params": {"images": 2, "side": 16, "pool": 2,
                               "check_calls": 1, "trace_calls": 1}}
    r = _run(dst, "again-bulk", over, 1)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-2])
    assert res["metrics"]["flops_count.sr"]["value"] > 0
    assert set(res["metrics"]) == {"flops_count.sr"}
    r = _run(dst, "again-bulk", over, 0)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-2])
    assert set(res["metrics"]) == {"sr_mp_per_s", "setup_s"}


def test_a_tree_without_the_program_fails(tmp_path):
    dst = str(tmp_path)
    _copy_tree(dst)
    r = _run(dst, "gray3-bulk-bf16", {}, 0, with_port=False)
    assert r.returncode != 0
    assert '"correct"' not in r.stdout


SERVE = r'''
import json, sys, torch
from benchmark import calibrate
from benchmark.tests.small import SMALL
name = "overlap-serve-sweep"
r = calibrate.readings(name, 5, 1.0, ["program", "control"],
                       torch.device("cpu"), SMALL[name])
print(json.dumps(r))
print("LOADED", json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
'''


def test_the_serve_driver_answers_and_is_checked():
    r = subprocess.run([sys.executable, "-c", SERVE], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    got = json.loads(lines[-2])
    # the program's answers within a level or two on average; the float8
    # control further off
    assert got["window"]["failed"] == 0
    assert got["program"]["request_gap"] < got["control"]["request_gap"]
    loaded = json.loads(lines[-1][len("LOADED "):])
    assert not set(loaded) & {"jax", "jaxlib", "flax", "dcgan_sr_tpu"}


def test_runs_load_no_jax_and_no_jax_package():
    from benchmark.tests.small import SMALL
    for name in [w["name"] for w in harness.manifest()["workloads"]]:
        r = _run(ROOT, name, SMALL[name], 1)
        assert r.returncode == 0, r.stderr[-3000:]
        loaded = json.loads(r.stdout.strip().splitlines()[-1][len("LOADED "):])
        assert not set(loaded) & {"jax", "jaxlib", "flax", "dcgan_sr_tpu"}
        assert "dcgan_sr_tpu_torch" in loaded


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys, json\n"
            "import benchmark.reference.nets, benchmark.reference.sr, "
            "benchmark.reference.train_step, benchmark.reference.seam, "
            "benchmark.reference.precision\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in "
            "sys.modules})))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    loaded = set(json.loads(r.stdout.strip().splitlines()[-1]))
    assert not loaded & {"jax", "jaxlib", "flax", "dcgan_sr_tpu",
                         "dcgan_sr_tpu_torch"}
    ref_dir = os.path.join(ROOT, "benchmark", "reference")
    imports = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|flax|"
                         r"dcgan_sr_tpu|dcgan_sr_tpu_torch)\b", re.M)
    for f in os.listdir(ref_dir):
        if f.endswith(".py"):
            with open(os.path.join(ref_dir, f)) as src:
                assert not imports.search(src.read()), f


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "dcgan_sr_tpu_torch_like", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]
