"""The port's host fingerprint (dcgan_sr_tpu_torch/utils/host.py) against
the JAX package's machine_fingerprint, on this host and on fixture
/proc/cpuinfo texts: the tag keys on the stable identity lines only."""

import builtins
import io
import re

import pytest

from dcgan_sr_tpu.utils.cache import machine_fingerprint as j_fingerprint
from dcgan_sr_tpu_torch.utils.host import machine_fingerprint

import torch_threads  # noqa: F401

BLOCK = """processor\t: {n}
vendor_id\t: GenuineIntel
cpu family\t: 6
model\t\t: 143
model name\t: Intel(R) Xeon(R) Platinum 8480C
stepping\t: 8
cpu MHz\t\t: {mhz}
cache size\t: 107520 KB
flags\t\t: fpu vme de pse tsc msr {flag} avx512f amx_tile
bogomips\t: 4000.00
"""


def cpuinfo(mhz=2000.0, flag="sse4_2", cores=4):
    return "\n".join(BLOCK.format(n=i, mhz=mhz + i, flag=flag)
                     for i in range(cores))


@pytest.fixture
def fake_cpuinfo(monkeypatch):
    """Serve `text` as /proc/cpuinfo to every reader (both packages' open)."""
    real = builtins.open
    box = {}

    def fake_open(path, *a, **kw):
        if path == "/proc/cpuinfo":
            return io.StringIO(box["text"])
        return real(path, *a, **kw)

    monkeypatch.setattr(builtins, "open", fake_open)
    return box


def test_fingerprint_equals_the_jax_packages_on_this_host():
    tag, desc = machine_fingerprint()
    assert (tag, desc) == j_fingerprint()
    assert re.fullmatch(r"[0-9a-f]{10}", tag)


@pytest.mark.parametrize("mhz", [800.0, 2000.0, 3712.5])
def test_cpu_mhz_does_not_move_the_tag(fake_cpuinfo, mhz):
    fake_cpuinfo["text"] = cpuinfo()
    base = machine_fingerprint()
    fake_cpuinfo["text"] = cpuinfo(mhz=mhz)
    got = machine_fingerprint()
    assert got == base == j_fingerprint()
    assert got[1] == "4 cores, Intel(R) Xeon(R) Platinum 8480C"


def test_another_flag_or_model_moves_the_tag(fake_cpuinfo):
    fake_cpuinfo["text"] = cpuinfo()
    base = machine_fingerprint()[0]
    fake_cpuinfo["text"] = cpuinfo(flag="avx2")
    other = machine_fingerprint()
    assert other[0] != base and other == j_fingerprint()
    fake_cpuinfo["text"] = cpuinfo().replace("8480C", "8468")
    assert machine_fingerprint()[0] not in (base, other[0])
    # a cpuinfo without a model name line: the JAX package's description
    fake_cpuinfo["text"] = "processor\t: 0\nflags\t\t: fpu\n"
    assert machine_fingerprint() == j_fingerprint()
    assert machine_fingerprint()[1] == "0 cores, unknown"
