"""The fused bulge pair's share of its roofline, in %: the least time its
work could take on the card (the larger of its operations over the dense
bf16 peak and its bytes over HBM's rate, benchmark/flops.py pair_work, for
every call in the traced stretch) over the device time of the kernels that
do it, found in the trace by the names below."""

# the statistics and main kernels of csrc/bulge_wgmma.cu (namespaces wg,
# bf16, and wgf, fp32) and of csrc/bulge.cu
KERNELS = ("bulge_stats_kernel", "bulge_main_kernel", "wgf::stats_kernel",
           "wgf::main_kernel")


def read(ctx):
    t, bound = ctx.trace, ctx.work.get("pair_bound_s")
    if t is None or not bound:
        return None
    secs, count = t.kernel_seconds(lambda n: any(k in n for k in KERNELS))
    if count == 0 or secs <= 0:
        return None
    return 100.0 * bound / secs
