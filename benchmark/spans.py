"""What the per-layer metrics that read the program's own spans share.

The spans (dcgan_sr_tpu_torch/utils/profiling.py) are on while a profiler
runs, so in a run with --trace 1 they record the traced stretch's calls;
their totals are read in the process once the window has closed.  A
program without spans gives None, and so does one whose spans recorded none
of the names asked for.
"""

from __future__ import annotations

# the train step's stages, which tile a step (train/step.py)
TRAIN_STAGES = ("train.preprocess", "train.g_forward", "train.d_real",
                "train.d_fake_forward", "train.d_fake_pullbacks",
                "train.g_backward", "train.pmeans", "train.adam")


def totals():
    """The program's span totals ({name: {"count", "host_s", "device_s",
    "self_device_s"}}), or None where the program has none."""
    try:
        from dcgan_sr_tpu_torch.utils.profiling import span_totals
    except ImportError:
        return None
    return span_totals() or None


def device_s(t, names):
    """Device seconds of the spans named, and whether any was recorded."""
    hit = [t[n]["device_s"] for n in names if n in t]
    return sum(hit), bool(hit)


def share(parts, whole):
    """% of the device seconds of the spans `whole` that the spans `parts`
    take; `whole` may be a predicate on a span's name."""
    t = totals()
    if t is None:
        return None
    if callable(whole):
        whole = [n for n in t if whole(n)]
    num, found = device_s(t, parts)
    den, _ = device_s(t, whole)
    if not found or den <= 0:
        return None
    return 100.0 * num / den


def sr_stage(name):
    """A stage of the SR pipeline: the spans sr.*, siblings at the top."""
    return name.startswith("sr.")
