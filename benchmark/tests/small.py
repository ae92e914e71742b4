"""Small sizes of the cells, for the CPU: the same code at batches and
image sizes a test run can hold; the SR cells keep their published widths
(the control's float8 gap shrinks with the width), the trainer is narrowed
as well."""

SMALL = {
    "gray3-train-bf16": {"config": {"ngf": 4, "ndf": 8},
                         "traffic_params": {"batch": 4, "steps_per_call": 3,
                                            "trace_calls": 1}},
    "overlap-bulk-bf16": {"config": {},
                          "traffic_params": {"images": 2, "pool": 2,
                                             "check_calls": 1,
                                             "trace_calls": 1}},
    "overlap-serve-sweep": {"config": {"ngf": 4},
                           "traffic_params": {"rate": 20, "sizes": [16, 32],
                                              "clients": 4,
                                              "check_per_size": 2}},
    "gray3-bulk-bf16": {"config": {},
                        "traffic_params": {"images": 2, "side": 16,
                                           "pool": 2, "check_calls": 1,
                                           "trace_calls": 1}},
}


def run_small(name, seed=12345678901, seconds=1.0, trace=0, overrides=None):
    """One run of a cell on the CPU at its small size: (code, result)."""
    import io
    import time

    import torch

    from benchmark import harness

    out, err = io.StringIO(), io.StringIO()
    code, res = harness.run(name, seed, seconds, trace,
                            t_start=time.perf_counter(),
                            device=torch.device("cpu"),
                            overrides=overrides or SMALL[name],
                            out=out, err=err)
    return code, res, out.getvalue(), err.getvalue()
