"""mfu.prefill (%): the model FLOPs of the traced prefill forwards
(benchkit.counts.model_flops, from the configuration file's sizes) over
the time the device was busy with them and the card's bf16 dense peak
(benchkit.counts.PEAK_BF16_FLOPS, 989 TFLOP/s, H100 SXM data sheet).
Busy time is the summed device time of every op in the profiler's trace
of the window (benchkit.device), so the host's idle gaps, which
device_idle.prefill reads, are not in it."""

from benchkit import counts


def read(ctx):
    if ctx.kind != "prefill" or not ctx.units or ctx.busy_s <= 0:
        return None
    return 100.0 * ctx.units * ctx.flops_per_unit \
        / (ctx.busy_s * counts.PEAK_BF16_FLOPS)
