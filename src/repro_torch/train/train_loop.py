"""Train step + loop: loss, gradients, optimizer, microbatch accumulation.

``make_train_step`` builds the step the launcher runs
(:mod:`repro_torch.launch.train`): the forward and backward through
autograd (the SSD scan and the MoE gate launch their kernels on the card,
with plain PyTorch backwards), optional top-k gradient compression, then
AdamW. Gradient accumulation runs the microbatches one after another and
sums their gradients in the parameters' dtype before dividing by
``grad_accum``, as the reference's scan does. A step is functional: it
returns a new state and leaves the one it was given as it was.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim import grad_compression as GC
from repro_torch.optim import optimizers as O
from repro_torch.optim.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: O.AdamWConfig = dataclasses.field(default_factory=O.AdamWConfig)
    grad_accum: int = 1
    compression: Optional[GC.CompressionConfig] = None

    @property
    def compressing(self) -> bool:
        return bool(self.compression and self.compression.enabled)


class TrainState(NamedTuple):
    params: Any
    opt: O.AdamWState
    ef: Optional[GC.EFState]
    step: torch.Tensor         # () int32


def init_train_state(generator: torch.Generator, cfg: ModelConfig,
                     tcfg: TrainConfig,
                     device: Union[str, torch.device, None] = None
                     ) -> TrainState:
    """Random parameters from ``generator`` (:func:`transformer.init_params`)
    on ``device`` (``None`` = ``cuda``; raises when CUDA is absent), zero
    moments, a zero error buffer when compressing, step 0."""
    params = T.init_params(generator, cfg, device)
    opt = O.init_adamw(params, tcfg.optimizer)
    ef = GC.init_ef(params) if tcfg.compressing else None
    return TrainState(params, opt, ef,
                      torch.zeros((), dtype=torch.int32,
                                  device=params["embed"].device))


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, Any]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(ce + aux, {"ce", "aux"}) of ``batch`` ("tokens", "labels", and an
    optional "mask", "patches" (vlm) and "frames" (audio), numpy arrays or
    tensors)."""
    dev = params["embed"].device
    extra = {k: batch[k] for k in ("patches", "frames") if k in batch}
    logits, aux = T.forward(params, cfg, batch["tokens"], **extra)
    labels = torch.as_tensor(batch["labels"], device=dev)
    mask = batch.get("mask")
    if mask is not None:
        mask = torch.as_tensor(mask, device=dev)
    ce = L.cross_entropy(logits, labels, mask)
    return ce + aux, {"ce": ce, "aux": aux}


def grads_of(params, cfg: ModelConfig, batch: Dict[str, Any]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
    """(loss, parts, gradients in each parameter's dtype) of ``batch``; a
    parameter the loss does not reach gets a zero gradient."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, parts = loss_fn(tree_unflatten(params, leaves), cfg, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return (loss.detach(), {k: v.detach() for k, v in parts.items()},
            tree_unflatten(params, grads))


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig
                    ) -> Callable[[TrainState, Dict[str, Any]],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """The train step: ``step(state, batch) -> (new state, metrics)`` with
    metrics ``loss``, ``ce``, ``aux``, ``grad_norm``, ``lr`` and, when
    compressing, ``kept_fraction`` (0-dim tensors). With ``grad_accum``
    > 1 the batch's leading axis splits into that many microbatches, and
    ``ce`` is the mean loss (``aux`` 0), as in the reference."""
    ga = tcfg.grad_accum

    def train_step(state: TrainState, batch: Dict[str, Any]):
        if ga > 1:
            rows = len(batch["tokens"])
            if rows % ga:
                raise ValueError(f"batch of {rows} rows does not split into "
                                 f"{ga} microbatches")
            mb = rows // ga
            grads = tree_map(torch.zeros_like, state.params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=state.step.device)
            for i in range(ga):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                mloss, _, mgrads = grads_of(state.params, cfg, micro)
                tree_map(lambda acc, g: acc.add_(g), grads, mgrads)
                del mgrads
                loss = loss + mloss
            # a true division (a Python divisor would go through its
            # reciprocal on the card)
            n = torch.tensor(float(ga), device=loss.device)
            grads = tree_map(lambda g: g / n, grads)
            loss = loss / n
            parts = {"ce": loss, "aux": torch.zeros_like(loss)}
        else:
            loss, parts, grads = grads_of(state.params, cfg, batch)

        ef = state.ef
        stats: Dict[str, torch.Tensor] = {}
        if tcfg.compressing:
            grads, ef, stats = GC.compress_grads(grads, state.ef,
                                                 tcfg.compression)
        new_params, new_opt, om = O.adamw_update(
            tcfg.optimizer, state.params, grads, state.opt)
        metrics = {"loss": loss, **parts, **om, **stats}
        return TrainState(new_params, new_opt, ef, state.step + 1), metrics

    return train_step


def train_loop(state: TrainState, step_fn, batches, *, hooks=()
               ) -> Tuple[TrainState, list]:
    """Simple host-side loop (examples / integration tests). ``hooks`` are
    callables (step, state, metrics) -> None — used for checkpointing and
    fault-tolerance probes."""
    history = []
    for i, batch in enumerate(batches):
        state, metrics = step_fn(state, batch)
        history.append({k: float(v) for k, v in metrics.items()})
        for h in hooks:
            h(i, state, metrics)
    return state, history
