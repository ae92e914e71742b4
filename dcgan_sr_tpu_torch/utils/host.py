"""This host's identity for the measurement lines (the port's own copy of
dcgan_sr_tpu/utils/cache.py machine_fingerprint)."""

from __future__ import annotations

import hashlib
import platform

# the identity lines of /proc/cpuinfo's first processor block; `cpu MHz`
# moves with frequency scaling and is left out
STABLE = ("vendor_id", "cpu family", "model", "model name", "stepping",
          "flags")


def machine_fingerprint():
    """(tag, description) of this host: the tag is a 10-digit sha1 of the
    machine type and the stable identity lines of /proc/cpuinfo's first
    block, the description "N cores, <CPU model>".  Two runs on one host
    get one tag; a host with another CPU model or flag set gets another."""
    try:
        with open("/proc/cpuinfo") as f:
            text = f.read()
        lines = text.split("\n\n", 1)[0].splitlines()
        block = "\n".join(l for l in lines
                          if l.split(":", 1)[0].strip() in STABLE)
        model = next((l.split(":", 1)[1].strip() for l in lines
                      if l.startswith("model name")), "unknown")
        desc = f"{text.count('model name')} cores, {model}"
    except OSError:
        block = platform.processor()
        desc = block or "unknown"
    tag = hashlib.sha1((platform.machine() + block).encode()).hexdigest()[:10]
    return tag, desc
