"""attention_kernel.train (%): the share of the traced training steps'
``attention.scores`` spans (``repro_torch.tracing``, around
``attention._sdpa``: each layer's forward and its block remat's
recompute) that hold an ``attention.kernel`` span (around the fused GQA
attention kernel's launch). Attention's backward is no ``_sdpa`` call
and is not counted. None where the program has no such kernel (no
``repro_torch.kernels.gqa_attention``), keeps no ``attention.scores``
spans or dropped some."""

from benchkit import attention_kernel


def read(ctx):
    if ctx.kind != "train":
        return None
    return attention_kernel.share()
