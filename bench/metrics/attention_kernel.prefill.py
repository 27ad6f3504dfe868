"""attention_kernel.prefill (%): the share of the traced prefill
forwards' ``attention.scores`` spans (``repro_torch.tracing``, around
``attention._sdpa``: one a layer) that hold an ``attention.kernel`` span
(around the fused GQA attention kernel's launch): 100 where every
layer's attention ran the kernel, 0 where none did. None where the
program has no such kernel (no ``repro_torch.kernels.gqa_attention``),
keeps no ``attention.scores`` spans or dropped some."""

from benchkit import attention_kernel


def read(ctx):
    if ctx.kind != "prefill":
        return None
    return attention_kernel.share()
