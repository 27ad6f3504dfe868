"""optimizer_s.train (s): device seconds of the global norm, the clip and
AdamW per traced training step, from the program's
``train_step.optimizer`` spans (``repro_torch.tracing``, around
``optimizers.adamw_update``). A span's device seconds are its stretch of
the device timeline between the CUDA events at its edges, idle inside it
included. The profiler turns tracing on over the traced window only, so
the records hold the window's steps. None where the program keeps no
such spans (no ``repro_torch.tracing``, no records, no device times) or
dropped some."""


def read(ctx):
    if ctx.kind != "train" or not ctx.units:
        return None
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    if tracing.COUNTS["dropped"]:
        return None
    times = [r["device_s"] for r in tracing.records()
             if r["name"] == "train_step.optimizer"]
    if not times or None in times:
        return None
    return sum(times) / ctx.units
