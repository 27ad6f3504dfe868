"""gc_s.train (s): host seconds of Python's garbage collections inside
the program's ``train_step`` spans (``repro_torch.tracing``: the
``gc.callbacks`` clock read at the span's edges) per traced training
step. The profiler turns tracing on over the traced window only, so the
records hold the window's steps. None where the program keeps no such
spans (no ``repro_torch.tracing``, no records) or dropped some."""


def read(ctx):
    if ctx.kind != "train" or not ctx.units:
        return None
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    if tracing.COUNTS["dropped"]:
        return None
    counts = [r["counters"] for r in tracing.records()
              if r["name"] == "train_step"]
    if not counts or None in counts:
        return None
    return sum(c["gc_s"] for c in counts) / ctx.units
