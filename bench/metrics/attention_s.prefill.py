"""attention_s.prefill (s): device seconds of attention's score passes
per traced prefill forward, from the program's ``attention.scores`` spans
(``repro_torch.tracing``, around ``attention._sdpa``: the f32 K/V copies,
every query block's scores, mask, softmax and P V). A span's device
seconds are its stretch of the device timeline between the CUDA events
at its edges, idle inside it included. The profiler turns tracing on over
the traced window only, so the records hold the window's forwards. None
where the program keeps no such spans (no ``repro_torch.tracing``, no
records, no device times) or dropped some."""


def read(ctx):
    if ctx.kind != "prefill" or not ctx.units:
        return None
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    if tracing.COUNTS["dropped"]:
        return None
    times = [r["device_s"] for r in tracing.records()
             if r["name"] == "attention.scores"]
    if not times or None in times:
        return None
    return sum(times) / ctx.units
