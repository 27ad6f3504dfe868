"""Train step + loop: loss, gradients, optimizer, microbatch accumulation.

``make_train_step`` builds the step the launcher runs
(:mod:`repro_torch.launch.train`): the forward and backward through
autograd (the SSD scan and the MoE gate launch their kernels on the card,
with plain PyTorch backwards), optional top-k gradient compression, then
AdamW. Gradient accumulation runs the microbatches one after another and
sums their gradients in the parameters' dtype before dividing by
``grad_accum``, as the reference's scan does. A step is functional: it
returns a new state and leaves the one it was given as it was. With
``donate=True`` (the reference's ``donate_argnums``, which the launcher
and the dry run pass) it writes the new state into the tensors of the one
it was given and returns them: the same values, the state held once. The
caller must not read the old state after such a step.

``make_train_step(..., mesh=)`` is the step of one rank of a ``("data",
"model")`` mesh (:func:`repro_torch.sharding.specs.lm_mesh`). Its state
(parameters, AdamW moments, error feedback) lives as this rank's blocks
under :func:`repro_torch.sharding.specs.param_pspecs`
(:func:`init_train_state` with ``mesh=`` builds it so); every rank gets
the whole batch and takes its block of each microbatch's rows over the
axes that divide them (:func:`repro_torch.sharding.specs.lm_row_axes`),
the rows replicated over the rest. The forward splits its work over
``model`` as :func:`repro_torch.models.transformer.tp_plan` lays it out
(tensor parallelism, and sequence parallelism under ``act_sp``): the
leaves the plan keeps split stay this rank's blocks, and the step
gathers whole only the others (those whose split is not head-aligned,
Mamba2's packed ``in_proj``, and the expert blocks' DP split without
``ep_fsdp``). A whole leaf's gradient is the whole one on every rank and
a split leaf's its block; each is summed over the ranks the rows are
split over. Without compression the gradients stay blocks: the clip's
global norm sums each block's squares over the axes that split its leaf
and AdamW runs on the blocks. With compression the chunked top-k
(:func:`repro_torch.optim.grad_compression.compress_grads`) chunks each
whole flattened gradient, so that path gathers the gradients and the
error buffer whole, as the reference's values need.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim import grad_compression as GC
from repro_torch.optim import optimizers as O
from repro_torch.optim.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.sharding import specs as SH


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
                     device: Union[str, torch.device, None] = None, *,
                     mesh=None) -> TrainState:
    """Random parameters from ``generator`` (:func:`transformer.init_params`)
    on ``device`` (``None`` = ``cuda``; raises when CUDA is absent), zero
    moments, a zero error buffer when compressing, step 0.

    ``mesh``: this rank's blocks under :func:`state_pspecs`, the same
    draws as without a mesh: each parameter is cut as soon as it is drawn
    (a stacked one layer by layer), and the moments and the error buffer
    are made as blocks."""
    cut = None if mesh is None \
        else T.block_cut(state_pspecs(cfg, tcfg, mesh).params, mesh)
    params = T.init_params(generator, cfg, device, cut=cut)
    opt = O.init_adamw(params, tcfg.optimizer)
    ef = GC.init_ef(params) if tcfg.compressing else None
    return TrainState(params, opt, ef,
                      torch.zeros((), dtype=torch.int32,
                                  device=params["embed"].device))


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, Any], *, mesh=None,
            batch_axes=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(ce + aux, {"ce", "aux"}) of ``batch`` ("tokens", "labels", and an
    optional "mask", "patches" (vlm) and "frames" (audio), numpy arrays or
    tensors).

    ``mesh``: ``batch`` is this rank's block of rows over ``batch_axes``
    (default :func:`repro_torch.sharding.specs.lm_batch_axes`) and
    ``params`` as :func:`repro_torch.models.transformer.forward` takes
    them. Where the rows are split, ``ce`` is this rank's share (its
    tokens' loss over the whole batch's token count), so the ranks' shares
    and their gradients add up to the batch's; ``aux`` is the whole
    batch's."""
    dev = params["embed"].device
    extra = {k: batch[k] for k in ("patches", "frames") if k in batch}
    if mesh is not None and batch_axes is None:
        batch_axes = SH.lm_batch_axes(mesh, cfg.batch_over_model)
    labels = torch.as_tensor(batch["labels"], device=dev)
    mask = batch.get("mask")
    if mask is not None:
        mask = torch.as_tensor(mask, device=dev)
    rows = SH.live_axes(mesh, batch_axes)
    total = SH.all_reduce(L.token_count(labels, mask), rows, mesh) \
        if rows else None
    if T.vocab_parallel(cfg, mesh):
        logits, aux = T.forward(params, cfg, batch["tokens"], **extra,
                                mesh=mesh, batch_axes=batch_axes)
        ce = L.cross_entropy(logits, labels, mask, total=total,
                             tp=L.TP(mesh))
    else:
        x, aux = T.hidden(params, cfg, batch["tokens"], **extra, mesh=mesh,
                          batch_axes=batch_axes)
        ce = L.head_cross_entropy(x, T._head(params, cfg), labels, mask,
                                  total=total)
    return ce + aux, {"ce": ce, "aux": aux}


def grads_of(params, cfg: ModelConfig, batch: Dict[str, Any], *, mesh=None,
             batch_axes=None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
    """(loss, parts, gradients in each parameter's dtype) of ``batch``; a
    parameter the loss does not reach gets a zero gradient. ``mesh``,
    ``batch_axes``: as :func:`loss_fn`; the gradients are this rank's
    terms."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        with tracing.span("train_step.forward"):
            loss, parts = loss_fn(tree_unflatten(params, leaves), cfg,
                                  batch, mesh=mesh, batch_axes=batch_axes)
        with tracing.span("train_step.backward"):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return (loss.detach(), {k: v.detach() for k, v in parts.items()},
            tree_unflatten(params, grads))


def _micro(batch: Dict[str, Any], ga: int):
    """The ``ga`` microbatches of ``batch`` along its leading axis."""
    rows = len(batch["tokens"])
    if rows % ga:
        raise ValueError(f"batch of {rows} rows does not split into "
                         f"{ga} microbatches")
    mb = rows // ga
    return [{k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            for i in range(ga)], mb


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, *, mesh=None,
                    donate: bool = False
                    ) -> Callable[[TrainState, Dict[str, Any]],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """The train step: ``step(state, batch) -> (new state, metrics)`` with
    metrics ``loss``, ``ce``, ``aux``, ``grad_norm``, ``lr`` and, when
    compressing, ``kept_fraction`` (0-dim tensors). With ``grad_accum``
    > 1 the batch's leading axis splits into that many microbatches, and
    ``ce`` is the mean loss (``aux`` 0), as in the reference.

    ``mesh``: the step of one rank of a ``("data", "model")`` mesh (see
    the module docstring); ``state`` holds this rank's blocks, ``batch``
    is whole, the metrics are the whole batch's on every rank. The mesh
    step's gradients end in the parameters' layout, which the reference's
    ``grad_pspecs`` pins.

    ``donate``: the step updates ``state`` in place (parameters, moments,
    error feedback, both step counters) and returns it, bit for bit the
    functional step's values (see the module docstring)."""
    if mesh is not None:
        return _mesh_train_step(cfg, tcfg, mesh, donate)
    ga = tcfg.grad_accum

    def train_step(state: TrainState, batch: Dict[str, Any]):
        with tracing.span("train_step", counters=True):
            return _step(state, batch)

    def _step(state: TrainState, batch: Dict[str, Any]):
        if ga > 1:
            micros, _ = _micro(batch, ga)
            with tracing.span("train_step.accumulators"):
                grads = tree_map(torch.zeros_like, state.params)
                loss = torch.zeros((), dtype=torch.float32,
                                   device=state.step.device)
            for micro in micros:
                mloss, _, mgrads = grads_of(state.params, cfg, micro)
                with tracing.span("train_step.accumulate"):
                    tree_map(lambda acc, g: acc.add_(g), grads, mgrads)
                    del mgrads
                    loss = loss + mloss
            with tracing.span("train_step.accumulate"):
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
            grads, ef, stats = GC.compress_grads(
                grads, state.ef, tcfg.compression, donate=donate)
        new_params, new_opt, om = O.adamw_update(
            tcfg.optimizer, state.params, grads, state.opt, donate=donate)
        metrics = {"loss": loss, **parts, **om, **stats}
        return TrainState(new_params, new_opt, ef,
                          _next_step(state.step, donate)), metrics

    return train_step


def state_pspecs(cfg: ModelConfig, tcfg: TrainConfig, mesh) -> TrainState:
    """The spec tree of a ``TrainState`` of ``cfg`` under ``mesh``: the
    layout of the mesh step's state (embeddings replicated under
    ``batch_over_model``, as the reference's launcher lays them out). The
    whole shapes come from a state initialised on the ``meta`` device."""
    whole = init_train_state(torch.Generator(), cfg, tcfg, device="meta")
    return SH.param_pspecs(whole, mesh,
                           replicate_embed=cfg.batch_over_model)


def _mesh_grads(cfg: ModelConfig, tcfg: TrainConfig, mesh):
    """``grads(params, batch) -> (loss, parts, gradients)`` of the mesh
    step: ``params`` this rank's blocks under :func:`state_pspecs`, the
    batch whole; the gradients in the forward's layout (the plan's split
    leaves as blocks, the rest whole), summed over the ranks the rows are
    split over and averaged over the microbatches."""
    pspecs = state_pspecs(cfg, tcfg, mesh).params
    fspecs = T.tp_plan(cfg, mesh)
    # what the forward gathers of each block
    fetch = tree_map(SH.spec_minus, pspecs, fspecs)
    ga = tcfg.grad_accum

    def grads_fn(blocks, batch: Dict[str, Any]):
        micros, mb = _micro(batch, ga)
        # the axes the rows split over, and those each forward leaf's
        # gradient is summed over: the rows' axes its spec leaves out
        row_axes = SH.lm_row_axes(mesh, mb, cfg.batch_over_model)
        sums = tree_map(lambda keep: tuple(
            a for a in row_axes if a not in SH.spec_axes(keep)), fspecs)
        rows = SH.block_slice(mesh, mb, row_axes or None)
        params = tree_map(lambda p, f: SH.gather(p, f, mesh), blocks, fetch)
        loss = grads = None
        for micro in micros:
            mine = {k: v[rows] for k, v in micro.items()}
            mloss, parts, mgrads = grads_of(params, cfg, mine, mesh=mesh,
                                            batch_axes=row_axes)
            if row_axes:
                ce = SH.all_reduce(parts["ce"], row_axes, mesh)
                parts = {"ce": ce, "aux": parts["aux"]}
                mloss = ce + parts["aux"]
            if ga == 1:
                loss, grads = mloss, mgrads
                break
            if grads is None:
                with tracing.span("train_step.accumulators"):
                    grads = tree_map(torch.zeros_like, params)
                    loss = torch.zeros((), dtype=torch.float32,
                                       device=mloss.device)
            with tracing.span("train_step.accumulate"):
                tree_map(lambda acc, g: acc.add_(g), grads, mgrads)
                del mgrads
                loss = loss + mloss
        del params
        grads = tree_map(lambda g, axes: SH.all_reduce(g, axes, mesh),
                         grads, sums)
        if ga > 1:
            with tracing.span("train_step.accumulate"):
                n = torch.tensor(float(ga), device=loss.device)
                grads = tree_map(lambda g: g / n, grads)
                loss = loss / n
            parts = {"ce": loss, "aux": torch.zeros_like(loss)}
        return loss, parts, grads

    return grads_fn, fspecs, fetch


def _cut(g: torch.Tensor, spec: SH.Spec, mesh) -> torch.Tensor:
    """This rank's block of ``g`` over the live entries of ``spec``
    (``g`` itself where there is none)."""
    if not any(SH.split(mesh, e) for e in spec):
        return g
    return SH.shard_of(g, spec, mesh)


def _global_norm_blocks(grads, pspecs, mesh) -> torch.Tensor:
    """:func:`repro_torch.optim.optimizers.global_norm` of the whole
    gradients from this rank's blocks (``pspecs``: each leaf's layout):
    each leaf's f32 sum of squares is summed over the axes of more than
    one rank that split it (one all-reduce per distinct set of axes), a
    replicated leaf's counted once, then the root of the sum. Without
    such axes it computes what ``global_norm`` does, op for op."""
    leaves = tree_leaves(grads)
    axes = [SH.live_axes(mesh, SH.spec_axes(s)) for s in tree_leaves(
        tree_map(lambda g, s: s, grads, pspecs))]
    sq = torch.stack([torch.sum(torch.square(g.to(torch.float32)))
                      for g in leaves])
    groups: Dict[Tuple[str, ...], list] = {}
    for i, a in enumerate(axes):
        if a:
            groups.setdefault(tuple(sorted(a)), []).append(i)
    if groups:
        sq = sq.clone()
        for a, idx in groups.items():
            idx = torch.tensor(idx, device=sq.device)
            sq[idx] = SH.all_reduce(sq[idx], a, mesh)
    return torch.sqrt(torch.sum(sq))


def _next_step(step: torch.Tensor, donate: bool) -> torch.Tensor:
    return step.add_(1) if donate else step + 1


def _mesh_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh,
                     donate: bool = False):
    """:func:`make_train_step` under ``mesh``."""
    st_specs = state_pspecs(cfg, tcfg, mesh)
    pspecs = st_specs.params
    grads_fn, fspecs, fetch = _mesh_grads(cfg, tcfg, mesh)

    def train_step(state: TrainState, batch: Dict[str, Any]):
        with tracing.span("train_step", counters=True):
            return _step(state, batch)

    def _step(state: TrainState, batch: Dict[str, Any]):
        loss, parts, grads = grads_fn(state.params, batch)
        ef = state.ef
        stats: Dict[str, torch.Tensor] = {}
        if tcfg.compressing:
            # whole gradients for the chunked top-k
            grads = tree_map(lambda g, f: SH.gather(g, f, mesh), grads,
                             fspecs)
            whole_ef = SH.gather_tree(state.ef, st_specs.ef, mesh)
            grads, whole_ef, stats = GC.compress_grads(
                grads, whole_ef, tcfg.compression, donate=donate)
            if donate:
                # the rank's blocks of the new error, into its buffers
                ef = SH.put_blocks(state.ef, whole_ef, st_specs.ef, mesh)
            else:
                ef = SH.shard_tree(whole_ef, st_specs.ef, mesh)
            del whole_ef
            norm = O.global_norm(grads)
            grads = SH.shard_tree(grads, pspecs, mesh)
        else:
            grads = tree_map(lambda g, f: _cut(g, f, mesh), grads, fetch)
            norm = _global_norm_blocks(grads, pspecs, mesh)
        new_params, new_opt, om = O.adamw_update(
            tcfg.optimizer, state.params, grads, state.opt, grad_norm=norm,
            donate=donate)
        metrics = {"loss": loss, **parts, **om, **stats}
        return TrainState(new_params, new_opt, ef,
                          _next_step(state.step, donate)), metrics

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
