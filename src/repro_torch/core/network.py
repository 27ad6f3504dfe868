"""Multi-layer TNN: a stack of TNNLayers over a stream of volleys.

Each layer's post-WTA output spikes — at most one line hot per column,
carrying the winner's fire time — form the input volley of the next layer.
Flattened, layer l emits ``n_columns * n_neurons`` lines, which must equal
layer l+1's ``n_inputs`` (checked at construction). Weights are a tuple of
(C, Q, rf_total) float tensors.

A recurrent layer (``TNNLayer.recurrent``) also sees its own previous-cycle
output volley, so :func:`forward` threads an explicit per-layer ``carry``
(previous outputs in, this cycle's outputs out).

:func:`step` is the learning cycle: the forward plus every layer's
minibatch STDP, weights in and weights out; :func:`train_network` runs it
over a stream.

Over a ``("data", "column")`` mesh (``mesh=``) every rank passes the same
whole volleys and carries, holds its block of each layer's weights
(:func:`param_shardings`, :func:`init_network`) and gets the whole results
back. Inside :func:`forward` each rank keeps its rows of the batch
(:func:`data_sharding`) from layer to layer, each layer's outputs
all-gathered over the ``column`` group, and the rows are all-gathered over
the ``data`` group once, at the end.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core import coding
from repro_torch.core import layer as layer_mod
from repro_torch.kernels.common import resolve_device
from repro_torch.sharding import specs as sharding_specs


@dataclasses.dataclass(frozen=True)
class TNNNetwork:
    layers: Tuple[layer_mod.TNNLayer, ...]

    def __post_init__(self):
        if not self.layers:
            raise ValueError("network needs at least one layer")
        for i in range(1, len(self.layers)):
            prev, cur = self.layers[i - 1], self.layers[i]
            if prev.n_outputs != cur.n_inputs:
                raise ValueError(
                    f"layer {i - 1} emits {prev.n_outputs} lines but layer "
                    f"{i} consumes {cur.n_inputs}")

    @property
    def n_inputs(self) -> int:
        return self.layers[0].n_inputs

    @property
    def n_outputs(self) -> int:
        return self.layers[-1].n_outputs

    @property
    def column_counts(self) -> Tuple[int, ...]:
        """Per-layer column counts."""
        return tuple(lc.n_columns for lc in self.layers)


def make_network(layers: Sequence[layer_mod.TNNLayer]) -> TNNNetwork:
    return TNNNetwork(layers=tuple(layers))


def param_shardings(cfg: TNNNetwork, mesh) -> Tuple[sharding_specs.Spec,
                                                    ...]:
    """Per-layer specs of the (C_l, Q_l, rf_l) weight stacks: columns over
    the ``column`` axis, whole on every rank when C_l does not divide it."""
    return tuple(sharding_specs.tnn_param_pspec(mesh, lc.n_columns)
                 for lc in cfg.layers)


def data_sharding(cfg: TNNNetwork, mesh, batch: int) -> sharding_specs.Spec:
    """Spec of a (B, n_inputs) input volley batch: B over ``data``."""
    del cfg  # shape-independent; kept for signature symmetry
    return sharding_specs.tnn_batch_pspec(mesh, batch)


def init_network(generator: torch.Generator, cfg: TNNNetwork,
                 device: Union[str, torch.device, None] = None, *,
                 mesh=None) -> Tuple[torch.Tensor, ...]:
    """Random per-layer weights from ``generator``, on ``device``
    (``None`` = ``cuda``; raises when CUDA is absent).

    With ``mesh`` (``device`` then defaults to the mesh's, and must agree
    with it) every rank draws the same whole weights and keeps its block
    under :func:`param_shardings`."""
    if mesh is not None:
        dev = sharding_specs.mesh_device(mesh, device)
    else:
        dev = resolve_device(device)
    params = tuple(layer_mod.init_layer(generator, lc, dev)
                   for lc in cfg.layers)
    if mesh is None:
        return params
    return tuple(sharding_specs.shard_of(p, spec, mesh)
                 for p, spec in zip(params, param_shardings(cfg, mesh)))


class ForwardResult(NamedTuple):
    """Everything one gamma cycle produces (:func:`forward`).

    ``out``: (B, C_last, Q_last) int32 post-WTA spike times of the last
    layer. ``winners``: per-layer (B, C_l) winner indices. ``carry``:
    per-layer next-cycle carry — layer l's flattened output volley
    (B, n_outputs_l) for recurrent layers, ``None`` for feedforward ones.
    ``densities``: per-layer measured input densities when requested, else
    ``None``. A 1-D single volley drops the batch dim from every tensor.
    """

    out: torch.Tensor
    winners: Tuple[torch.Tensor, ...]
    carry: Tuple[Optional[torch.Tensor], ...]
    densities: Optional[List[float]]


def init_carry(cfg: TNNNetwork, batch: int,
               device: Union[str, torch.device, None] = None
               ) -> Tuple[Optional[torch.Tensor], ...]:
    """Per-layer all-silent carry for the first gamma cycle of a stream:
    (batch, n_outputs_l) all-``NO_SPIKE`` for recurrent layers, ``None``
    for feedforward ones; on ``device`` (``None`` = ``cuda``; raises when
    CUDA is absent)."""
    dev = resolve_device(device)
    return tuple(layer_mod.carry_init(lc, batch, dev) if lc.recurrent
                 else None for lc in cfg.layers)


def forward(params: Sequence[torch.Tensor], volleys: torch.Tensor,
            cfg: TNNNetwork, *, microbatches: int = 1,
            with_densities: bool = False,
            carry: Optional[Sequence[Optional[torch.Tensor]]] = None,
            mesh=None) -> ForwardResult:
    """One gamma cycle through the whole stack.

    ``microbatches > 1`` runs the software-pipelined schedule (bit-exact vs
    the barriered one for every backend and any M); ``with_densities=True``
    records each layer's measured input density (barriered only); ``carry``
    threads recurrent state, ``None`` entries (or ``carry=None``) meaning
    the all-silent first cycle of a stream.

    Args:
      params:  per-layer weights, layer l shaped (C_l, Q_l, rf_total_l).
      volleys: (B, n_inputs) int32 input spike volleys — or (n_inputs,).
      microbatches: pipeline micro-batches M (clamped to [1, B]).
      with_densities: also report per-layer measured input densities
        (requires ``microbatches == 1``).
      carry: per-layer carry-in, layer l (B, n_outputs_l) int32 for
        recurrent layers, ``None`` for feedforward ones.
      mesh: a ``("data", "column")`` mesh; ``params`` are then this rank's
        blocks (:func:`param_shardings`) and everything else whole.

    Returns:
      :class:`ForwardResult` — ``result.carry`` is the carry-in for the
      stream's next gamma cycle.
    """
    n_layers = len(cfg.layers)
    if carry is None:
        carry_in: Tuple[Optional[torch.Tensor], ...] = (None,) * n_layers
    else:
        if len(carry) != n_layers:
            raise ValueError(f"carry has {len(carry)} entries for "
                             f"{n_layers} layers")
        carry_in = tuple(carry)
    single = volleys.dim() == 1
    x = (volleys[None, :] if single else volleys).to(torch.int32)
    if single:
        carry_in = tuple(c[None, :] if c is not None and c.dim() == 1 else c
                         for c in carry_in)
    m, rows = microbatch_split(x.shape[0], microbatches)
    if with_densities and m > 1:
        raise ValueError("with_densities requires microbatches == 1 "
                         "(density measurement is a whole-batch "
                         "diagnostic)")
    for p, lc in zip(params, cfg.layers):
        sharding_specs.maybe_wsc(p, *sharding_specs.tnn_param_axes(),
                                 mesh=mesh, shape=(lc.n_columns,
                                                   lc.n_neurons, lc.rf_total))
    if m > 1:
        res = _forward_pipelined(params, x, cfg, carry_in, m, rows, mesh)
    else:
        res = _forward_barriered(params, x, cfg, carry_in, with_densities,
                                 mesh)
    if single:
        res = ForwardResult(
            out=res.out[0],
            winners=tuple(w[0] for w in res.winners),
            carry=tuple(c if c is None else c[0] for c in res.carry),
            densities=res.densities)
    return res


def _forward_barriered(params, x, cfg, carry_in, with_densities,
                       mesh=None) -> ForwardResult:
    """Whole-batch barrier at every layer (the M=1 schedule). Under a mesh
    each rank carries its rows from layer to layer, with every line of
    them, and the rows are gathered over ``data`` at the end."""
    b = x.shape[0]
    dp = None
    if mesh is not None:
        dp = sharding_specs.split(mesh, data_sharding(cfg, mesh, b)[0])
        rows = sharding_specs.block_slice(mesh, b, dp)
        x = x[rows]
        carry_in = tuple(None if c is None else c[rows] for c in carry_in)
    winners_all, carry_out = [], []
    densities: Optional[list] = [] if with_densities else None
    out = None
    for w, lc, c in zip(params, cfg.layers, carry_in):
        if densities is not None:
            # measured on the whole batch, the same on every rank
            whole = layer_mod._gather_rows(
                [x] + ([] if c is None else [c]), dp, mesh)
            densities.append(layer_mod.layer_input_density(
                whole[0], lc, whole[1] if c is not None else None))
        if mesh is None:
            out, winners = layer_mod.layer_forward(w, x, lc, c)
        else:
            out, winners = layer_mod._forward_block(w, x, lc, c, mesh, b)
        winners_all.append(winners)
        x = out.reshape(out.shape[0], lc.n_outputs)
        carry_out.append(x if lc.recurrent else None)
    if mesh is not None:
        out, winners_all, carry_out = _gather_cycle(out, winners_all,
                                                    carry_out, dp, mesh)
    return ForwardResult(out, tuple(winners_all), tuple(carry_out),
                         densities)


def _gather_cycle(out, winners, carries, dp, mesh):
    """All-gather one cycle's rows over the DP entry ``dp`` in one
    collective: the last layer's outputs, every layer's winners and the
    recurrent carries (``None`` entries pass through)."""
    rec = [c for c in carries if c is not None]
    got = layer_mod._gather_rows([out, *winners, *rec], dp, mesh)
    it = iter(got[1 + len(winners):])
    return (got[0], list(got[1:1 + len(winners)]),
            [None if c is None else next(it) for c in carries])


def microbatch_split(batch: int, microbatches: int) -> Tuple[int, int]:
    """(effective M, rows per micro-batch) for a pipelined split.

    Clamps ``microbatches`` to [1, batch], ceil-splits the rows, then
    recomputes the effective count (a ragged batch can need fewer
    micro-batches than requested). The serve engine's per-stage stats use
    the same split.
    """
    if batch <= 0:
        return 0, 0
    m = max(1, min(int(microbatches), batch))
    rows = -(-batch // m)
    return -(-batch // rows), rows


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """Append all-``NO_SPIKE`` rows (inert) up to ``rows``."""
    if x.shape[0] >= rows:
        return x
    pad = torch.full((rows - x.shape[0],) + tuple(x.shape[1:]),
                     coding.NO_SPIKE, dtype=x.dtype, device=x.device)
    return torch.cat([x, pad])


def _forward_pipelined(params, x, cfg, carry_in, m, rows,
                       mesh=None) -> ForwardResult:
    """One gamma cycle through the stack, software-pipelined.

    The batch splits into M micro-batches; at pipeline tick t, layer l
    computes micro-batch t - l, so the L layers work on distinct
    micro-batches. Warmup/drain ticks feed all-``NO_SPIKE`` stage buffers,
    which fire nothing, so the padding is inert; a ragged batch is padded
    the same way. A recurrent layer's carry rows ride the same schedule:
    tick l + j feeds micro-batch j's carry rows to layer l. Under a mesh
    each micro-batch's rows are split over ``data`` (the batch rule of
    ``specs.tnn_stage_pspec``; whole on every rank when the axis does not
    divide ``rows``), the stage buffers hold a rank's rows with every
    line, and each micro-batch is gathered at the end.
    """
    b = x.shape[0]
    n_layers = len(cfg.layers)
    dev = x.device
    xs = _pad_rows(x, m * rows).reshape(m, rows, x.shape[-1])
    carries = []
    for lc, c in zip(cfg.layers, carry_in):
        if not lc.recurrent:
            carries.append(None)
            continue
        c_full = c if c is not None else layer_mod.carry_init(lc, b, dev)
        carries.append(_pad_rows(c_full, m * rows).reshape(
            m, rows, lc.n_outputs))
    dp, mb = None, rows             # the split of a micro-batch, its rows
    layer_forward = layer_mod.layer_forward
    if mesh is not None:
        dp = sharding_specs.split(mesh, data_sharding(cfg, mesh, rows)[0])
        mine = sharding_specs.block_slice(mesh, rows, dp)
        xs = xs[:, mine]
        carries = [None if c is None else c[:, mine] for c in carries]
        mb = xs.shape[1]

        def layer_forward(w, inp, lc, c):
            return layer_mod._forward_block(w, inp, lc, c, mesh, rows)
    stage = [layer_mod.stage_init(lc, mb, dev) for lc in cfg.layers[1:]]
    outs: List[torch.Tensor] = []
    wins: List[List[torch.Tensor]] = [[] for _ in cfg.layers]
    couts: List[List[torch.Tensor]] = [[] for _ in cfg.layers]
    for tick in range(m + n_layers - 1):
        new_stage = []
        for i, (w, lc) in enumerate(zip(params, cfg.layers)):
            j = tick - i                      # this layer's micro-batch
            if i == 0:
                inp = xs[j] if j < m else layer_mod.stage_init(lc, mb, dev)
            else:
                inp = stage[i - 1]
            c_t = None
            if lc.recurrent:
                c_t = (carries[i][j] if 0 <= j < m
                       else layer_mod.carry_init(lc, mb, dev))
            out, win = layer_forward(w, inp, lc, c_t)
            flat = out.reshape(mb, lc.n_outputs)
            if 0 <= j < m:
                wins[i].append(win)
                if lc.recurrent:
                    couts[i].append(flat)
                if i == n_layers - 1:
                    outs.append(out)
            if i + 1 < n_layers:
                new_stage.append(flat)
        stage = new_stage
    if mesh is not None:
        for j in range(m):
            outs[j], win_j, cout_j = _gather_cycle(
                outs[j], [ws[j] for ws in wins],
                [cs[j] if lc.recurrent else None
                 for cs, lc in zip(couts, cfg.layers)], dp, mesh)
            for i, lc in enumerate(cfg.layers):
                wins[i][j] = win_j[i]
                if lc.recurrent:
                    couts[i][j] = cout_j[i]
    out = torch.cat(outs)[:b]
    winners = tuple(torch.cat(ws)[:b] for ws in wins)
    carry_out = tuple(torch.cat(cs)[:b] if lc.recurrent else None
                      for cs, lc in zip(couts, cfg.layers))
    return ForwardResult(out, winners, carry_out, None)


def measured_densities(params: Sequence[torch.Tensor],
                       volleys: torch.Tensor, cfg: TNNNetwork):
    """Per-layer measured input densities for one batch, recorded on the
    activations of one forward pass."""
    return forward(params, volleys, cfg, with_densities=True).densities


def sparse_widths(cfg: TNNNetwork, first: int) -> Tuple[int, ...]:
    """Per-layer compaction widths for a sparse stack.

    Layer 0 gets ``first`` — the caller's measured-and-bucketed active-line
    bound for its feedforward receptive-field gather. Deeper layers need no
    measurement: layer l consumes layer l-1's post-WTA lines, at most one
    active per block of ``Q_prev``, so an ``rf``-wide window covers at most
    ``(rf - 2) // Q_prev + 2`` blocks. A recurrent layer's Q carry lines are
    a post-WTA volley of its own column — at most one active — so its width
    grows by exactly 1.
    """
    widths = [max(int(first), 1) + (1 if cfg.layers[0].recurrent else 0)]
    for prev, cur in zip(cfg.layers, cfg.layers[1:]):
        q, rf = prev.n_neurons, cur.rf_size
        bound = 1 if rf <= 1 else min(rf, (rf - 2) // q + 2, prev.n_columns)
        widths.append(max(bound, 1) + (1 if cur.recurrent else 0))
    return tuple(widths)


class StepResult(NamedTuple):
    """Everything one *learning* gamma cycle produces (:func:`step`).

    ``params``: per-layer post-STDP weights — the explicit weight state a
    learning service threads from step to step. ``out`` / ``winners`` /
    ``carry`` mirror :class:`ForwardResult`: they are computed at the
    PRE-update weights (learning is applied after the cycle, like the
    hardware's post-WTA STDP datapath), so ``out`` is bit-exact with
    :func:`forward` at the same weights.
    """

    params: Tuple[torch.Tensor, ...]
    out: torch.Tensor
    winners: Tuple[torch.Tensor, ...]
    carry: Tuple[Optional[torch.Tensor], ...]


def step(params: Sequence[torch.Tensor], volleys: torch.Tensor,
         cfg: TNNNetwork, *, key: Optional[torch.Generator] = None,
         carry: Optional[Sequence[Optional[torch.Tensor]]] = None,
         draws: Optional[Sequence[torch.Tensor]] = None,
         mesh=None) -> StepResult:
    """Forward + layer-local minibatch STDP — THE learning entry point.

    One gamma cycle through the stack with every layer applying its own
    STDP update (:func:`repro_torch.core.layer.layer_step`): layer l learns
    from the volley it actually saw this cycle (the previous layer's
    PRE-update output), so a single sweep advances the whole stack. ``carry``
    threads recurrent state exactly like :func:`forward`; the returned
    ``carry`` feeds the stream's next cycle.

    The schedule is barriered: minibatch STDP reduces per-volley deltas
    across the whole batch, so there are no micro-batches. All-``NO_SPIKE``
    rows (a serving batch's free slots) contribute zero delta, so padding is
    inert for learning too; with the default ``"mean"`` reduction the batch
    size still sets the step scale.

    ``key=None`` with no ``draws`` selects the deterministic expectation
    rule; a ``torch.Generator`` the stochastic one, each layer drawing from
    it in turn; ``draws`` hands in each layer's ``(C, B, Q, rf_total)``
    uniforms instead. Returns :class:`StepResult`; a 1-D single volley
    drops the batch dim from every field except ``params``.

    Under ``mesh`` the params in and out are this rank's blocks and every
    other tensor whole (:func:`repro_torch.core.layer.layer_step`): the
    new params are the single-device ones, block by block.
    """
    n_layers = len(cfg.layers)
    if carry is None:
        carry_in: Tuple[Optional[torch.Tensor], ...] = (None,) * n_layers
    else:
        if len(carry) != n_layers:
            raise ValueError(f"carry has {len(carry)} entries for "
                             f"{n_layers} layers")
        carry_in = tuple(carry)
    if draws is not None and len(draws) != n_layers:
        raise ValueError(f"draws has {len(draws)} entries for {n_layers} "
                         f"layers")
    single = volleys.dim() == 1
    x = (volleys[None, :] if single else volleys).to(torch.int32)
    if single:
        carry_in = tuple(c[None, :] if c is not None and c.dim() == 1 else c
                         for c in carry_in)
    layer_draws = draws if draws is not None else (None,) * n_layers
    new_params, winners_all, carry_out = [], [], []
    out = None
    for w, lc, c, d in zip(params, cfg.layers, carry_in, layer_draws):
        new_w, out, winners = layer_mod.layer_step(w, x, lc, key, c,
                                                   draws=d, mesh=mesh)
        new_params.append(new_w)
        winners_all.append(winners)
        x = out.reshape(out.shape[0], lc.n_outputs)
        carry_out.append(x if lc.recurrent else None)
    res = StepResult(tuple(new_params), out, tuple(winners_all),
                     tuple(carry_out))
    if single:
        res = StepResult(
            params=res.params,
            out=res.out[0],
            winners=tuple(w[0] for w in res.winners),
            carry=tuple(c if c is None else c[0] for c in res.carry))
    return res


# repro-lint: unplaced (single-device stack; multi-GPU columns come later)
def network_step(params: Sequence[torch.Tensor], volleys: torch.Tensor,
                 cfg: TNNNetwork, key: Optional[torch.Generator] = None, *,
                 draws: Optional[Sequence[torch.Tensor]] = None
                 ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor,
                            Tuple[torch.Tensor, ...]]:
    """Feedforward wrapper over :func:`step` (no carry threading; a 1-D
    volley keeps its promoted batch dim).
    Returns (new_params, last_out_times, per_layer_winners).
    """
    x = volleys[None, :] if volleys.dim() == 1 else volleys
    res = step(params, x, cfg, key=key, draws=draws)
    return res.params, res.out, res.winners


# repro-lint: unplaced (single-device stack; multi-GPU columns come later)
def train_network(params: Sequence[torch.Tensor], volleys: torch.Tensor,
                  cfg: TNNNetwork, batch_size: int = 1,
                  key: Optional[torch.Generator] = None, *,
                  draws: Optional[Sequence[torch.Tensor]] = None
                  ) -> Tuple[Tuple[torch.Tensor, ...],
                             Tuple[torch.Tensor, ...]]:
    """Greedy simultaneous training over a stream (M, n_inputs) of volleys.

    ``draws`` hands in the stochastic rule's uniforms for the whole
    stream, one tensor per layer shaped
    ``(M // batch_size, C_l, batch_size, Q_l, rf_total_l)``.

    Returns (final_params, per-layer winners (M, C_l)).
    """
    per_step = None
    if draws is not None:
        if len(draws) != len(cfg.layers):
            raise ValueError(f"draws has {len(draws)} entries for "
                             f"{len(cfg.layers)} layers")
        per_step = [tuple(d[i] for d in draws)
                    for i in range(draws[0].shape[0])]

    def one(ps, batch, sk, sd):
        new_ps, _, winners = network_step(ps, batch, cfg, sk, draws=sd)
        return new_ps, winners

    final, winners = layer_mod.scan_minibatches(one, tuple(params), volleys,
                                                batch_size, key, per_step)
    return final, tuple(w.reshape(volleys.shape[0], lc.n_columns)
                        for w, lc in zip(winners, cfg.layers))
