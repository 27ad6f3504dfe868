"""device_idle.train (%): 1 - device busy / wall over the traced training
steps; busy is the summed time of the device's activity in the
profiler's trace (benchkit.device)."""


def read(ctx):
    if ctx.kind != "train" or not ctx.units or ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
