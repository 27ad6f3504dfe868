"""cuda_mallocs.train (calls): the CUDA caching allocator's ``cudaMalloc``
and ``cudaFree`` calls inside the program's ``train_step`` spans per
traced training step: the changes of ``torch.cuda.memory_stats()``'s
``num_device_alloc`` and ``num_device_free`` over each span
(``repro_torch.tracing``, read at its edges). The profiler turns tracing
on over the traced window only, so the records hold the window's steps.
None where the program keeps no such spans (no ``repro_torch.tracing``,
no records, no CUDA counts) or dropped some."""


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
    if not counts or any(c is None or "num_device_alloc" not in c
                         for c in counts):
        return None
    return sum(c["num_device_alloc"] + c["num_device_free"]
               for c in counts) / ctx.units
