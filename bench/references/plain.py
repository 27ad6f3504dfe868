"""The pieces every plain reference shares: matrix products in the
reference's precision (or the control's), RMSNorm, SiLU, the loss, the
parameter leaves, AdamW and the reference's training step.

Plain PyTorch only. Nothing here imports the program under test, JAX or
the JAX package: the reference works out again whatever the program
derives from the benchmark's inputs (the weights, the tokens).

Precision. ``Precision("f32")`` computes every product in float32 with
TF32 off (:func:`float32_products` switches it off for the duration).
``Precision("fp8")`` is the control: every product with a weight rounds
both operands to float8 e4m3 with one scale a tensor (the amax over 448),
and its backward rounds the incoming gradient to float8 e5m2 (amax over
57,344), as an fp8 training step's GEMMs do; sums stay float32. The
products inside attention are float32 in both.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Iterator, List, Sequence, Tuple

import torch
import torch.utils.checkpoint

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


@contextlib.contextmanager
def float32_products() -> Iterator[None]:
    """float32 products without TF32 inside the block, the flags restored
    after it."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _fp8(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """``x`` rounded to ``dtype`` under one scale for the whole tensor,
    back in float32."""
    amax = torch.amax(torch.abs(x.detach())).clamp(min=1e-30)
    scale = top / amax
    return (x * scale).to(dtype).to(torch.float32) / scale


class _Fp8Product(torch.autograd.Function):
    """``x @ w`` with e4m3 operands; the backward's products take the
    gradient in e5m2 and the operands as the forward rounded them."""

    @staticmethod
    def forward(ctx, x, w):
        xq = _fp8(x, torch.float8_e4m3fn, E4M3_MAX)
        wq = _fp8(w, torch.float8_e4m3fn, E4M3_MAX)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = _fp8(g, torch.float8_e5m2, E5M2_MAX)
        gx = gq @ wq.T
        gw = xq.reshape(-1, xq.shape[-1]).T @ gq.reshape(-1, gq.shape[-1])
        return gx, gw


class Precision:
    """How the reference multiplies by a weight: ``"f32"`` or ``"fp8"``
    (the control; see the module docstring)."""

    def __init__(self, name: str):
        if name not in ("f32", "fp8"):
            raise ValueError(f"precision must be 'f32' or 'fp8', got {name!r}")
        self.name = name

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        x, w = x.to(torch.float32), w.to(torch.float32)
        if self.name == "f32":
            return x @ w
        return _Fp8Product.apply(x, w)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) \
        * scale.to(torch.float32)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each position's cross-entropy, float32."""
    return torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, labels[..., None].long())[..., 0]


def mean_nll(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
             prec: Precision, rows: int = 2048) -> torch.Tensor:
    """The mean cross-entropy of ``x @ head`` against ``labels``, the
    logits made ``rows`` positions at a time (each part recomputed in the
    backward, so the whole logits are never held)."""
    xs = x.reshape(-1, x.shape[-1])
    ls = labels.reshape(-1)

    def part(xp, lp):
        return torch.sum(token_nll(prec.mm(xp, head), lp))
    total = sum(torch.utils.checkpoint.checkpoint(
        part, xs[lo:lo + rows], ls[lo:lo + rows], use_reentrant=False)
        for lo in range(0, ls.shape[0], rows))
    return total / ls.shape[0]


# ------------------------------------------------------------ leaves
STACKS = ("layers",)


def leaves(tree: Dict, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """Every leaf of a parameter tree by name, in sorted key order; a
    stacked leaf (under ``layers``) one layer at a time, each a view of
    the stack (``layers.3.attn.wq``)."""
    out: List[Tuple[str, torch.Tensor]] = []
    for k in sorted(tree):
        v, name = tree[k], f"{prefix}{k}"
        if k in STACKS and not prefix:
            for key, t in leaves(v):
                out += [(f"{name}.{i}.{key}", t[i]) for i in range(t.shape[0])]
        elif isinstance(v, dict):
            out += leaves(v, f"{name}.")
        else:
            out.append((name, v))
    return out


def layer_trees(tree: Dict) -> List[Dict]:
    """The per-layer trees of ``tree["layers"]`` (views of the stacks)."""
    def one(t, i):
        return {k: one(v, i) if isinstance(v, dict) else v[i]
                for k, v in t.items()}
    n = next(iter(leaves(tree["layers"])))[1].shape[0]
    return [one(tree["layers"], i) for i in range(n)]


def unflatten(names: Sequence[str], values: Sequence[torch.Tensor]) -> Dict:
    """A tree of per-layer leaves from :func:`leaves`' names: ``layers`` a
    list of per-layer trees."""
    tree: Dict = {}
    for name, v in zip(names, values):
        parts = name.split(".")
        if parts[0] in STACKS:
            layers = tree.setdefault(parts[0], {})
            node = layers.setdefault(int(parts[1]), {})
            parts = parts[2:]
        else:
            node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    for s in STACKS:
        if s in tree:
            tree[s] = [tree[s][i] for i in sorted(tree[s])]
    return tree


def leaf_norms(tree: Dict, minus: Sequence[torch.Tensor] | None = None,
               scale: float = 1.0) -> Dict[str, float]:
    """Each leaf's float32 norm by name (of ``leaf - minus[i]`` where
    ``minus``, the same leaves in :func:`leaves`' order on any device, is
    given, times ``scale``), read in one copy to the host."""
    named = leaves(tree)
    other = [None] * len(named) if minus is None else minus
    norms = torch.stack([torch.linalg.vector_norm(
        t.to(torch.float32) if o is None
        else t.to(torch.float32) - o.to(t.device, torch.float32)) * scale
        for (_, t), o in zip(named, other)])
    return dict(zip([n for n, _ in named], norms.tolist()))


# ------------------------------------------------------------ training
def schedule(opt: Dict, step: int) -> float:
    """Linear warm-up over ``warmup_steps``, then a cosine to
    ``min_lr_ratio`` of ``lr`` at ``total_steps``; ``step`` counts from 1
    for the first update."""
    if step < opt["warmup_steps"]:
        return opt["lr"] * step / max(1, opt["warmup_steps"])
    prog = min(1.0, max(0.0, (step - opt["warmup_steps"]) / max(
        1, opt["total_steps"] - opt["warmup_steps"])))
    r = opt["min_lr_ratio"]
    return opt["lr"] * (r + (1 - r) * 0.5 * (1 + math.cos(math.pi * prog)))


def train_steps(loss_of: Callable[[Dict, torch.Tensor, torch.Tensor,
                                   Precision], torch.Tensor],
                params: Dict, batches: Sequence[Tuple[torch.Tensor,
                                                      torch.Tensor]],
                opt: Dict, grad_accum: int, prec: Precision
                ) -> Dict[str, object]:
    """The reference's training steps on ``params`` (updated in place):
    each batch ``(tokens, labels)`` split into ``grad_accum``
    microbatches; the gradient of each taken in float32 from a float32
    copy of the parameters, summed in float32 and divided by
    ``grad_accum``; clipped to a global norm of ``opt["grad_clip"]``;
    AdamW (float32 moments, decoupled weight decay on every leaf, bias
    correction), the new parameters rounded to their dtype.

    Returns each step's loss and the first step's clipped gradient's
    norm by leaf (:func:`leaf_norms`' names)."""
    named = leaves(params)
    names = [n for n, _ in named]
    m = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
         for _, t in named]
    v = [torch.zeros_like(x) for x in m]
    b1, b2 = opt["beta1"], opt["beta2"]
    losses: List[float] = []
    first_grad: Dict[str, float] = {}
    for step, (tokens, labels) in enumerate(batches, start=1):
        acc = [torch.zeros_like(x) for x in m]
        loss = 0.0
        rows = tokens.shape[0] // grad_accum
        for i in range(grad_accum):
            master = [t.to(torch.float32).requires_grad_() for _, t in named]
            tree = unflatten(names, master)
            part = slice(i * rows, (i + 1) * rows)
            mloss = loss_of(tree, tokens[part], labels[part], prec)
            grads = torch.autograd.grad(mloss, master)
            for a, g in zip(acc, grads):
                a.add_(g)
            loss += float(mloss.detach())
            del master, tree, grads, mloss
        grads = [a / grad_accum for a in acc]
        del acc
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        scale = torch.clamp(opt["grad_clip"] / torch.clamp(norm, min=1e-9),
                            max=1.0)
        grads = [g * scale for g in grads]
        if step == 1:
            norms = torch.stack([torch.linalg.vector_norm(g) for g in grads])
            first_grad = dict(zip(names, norms.tolist()))
        lr = schedule(opt, step)
        bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
        with torch.no_grad():
            for (_, p), g, mi, vi in zip(named, grads, m, v):
                mi.mul_(b1).add_((1 - b1) * g)
                vi.mul_(b2).add_((1 - b2) * g * g)
                delta = (mi / bc1) / (torch.sqrt(vi / bc2) + opt["eps"]) \
                    + opt["weight_decay"] * p.to(torch.float32)
                p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))
        del grads
        losses.append(loss / grad_accum)
    return {"losses": losses, "first_grad": first_grad}
