"""Batched multi-column TNN layer.

A :class:`TNNLayer` is C independent columns side by side. Per gamma cycle:

  1. The layer receives a batch of B input volleys over ``n_inputs`` lines.
  2. Each column c reads its receptive field — ``rf_size`` lines starting
     at ``c * stride`` (overlap with ``rf_stride < rf_size``), followed, for
     a recurrent layer, by its own Q output lines of the previous cycle.
  3. All B x C x Q neurons integrate in one
     :func:`repro_torch.core.neuron.fire_times_bank` dispatch (one kernel
     launch over the column stack on a CUDA device).
  4. 1-WTA lateral inhibition per (volley, column): the earliest-firing
     neuron keeps its spike, ties going to the lowest index (the hardware
     priority encoder); losers are silenced.
  5. Minibatch STDP (``stdp.stdp_update_column_minibatch``, all columns
     at once) accumulates per-volley updates across the batch dimension;
     at B=1 it is bit-identical to the online per-volley rule of
     :func:`repro_torch.core.column.column_step`.

Weights are (C, Q, rf_total) float tensors, rounded to int32 at use.
Everything is functional: weights in, weights out.

Over a ``("data", "column")`` mesh (``mesh=``,
:mod:`repro_torch.sharding.specs`) every rank runs the same call on the
same whole volley batch and holds its block of the weights
(``specs.tnn_param_pspec``: its columns where the column axis divides C,
all of them otherwise). It gathers the receptive fields of its columns
for its rows (``specs.tnn_batch_pspec``), runs the bank and the 1-WTA on
that block, and all-gathers the post-WTA outputs over the ``column``
group (the next layer may read any column's lines) and the ``data``
group, so every rank returns the whole outputs. Learning updates each
rank's own columns.
"""

from __future__ import annotations

import dataclasses
from typing import (Callable, List, NamedTuple, Optional, Sequence,
                    Tuple, Union)

import torch

from repro_torch.core import coding, compaction, neuron, stdp
from repro_torch.core import policy as engine_policy
from repro_torch.kernels.common import resolve_device
from repro_torch.sharding import specs as sharding_specs

_I32 = torch.int32

#: axis entries for the block checks (specs.maybe_wsc): the post-gather
#: volleys (C, B, rf) and the fire times, columns over "column" and the
#: batch over DP; a (C, Q, rf) weight stack, columns over "column"
_COL, _DP, _ = sharding_specs.tnn_volley_axes()
_PARAM = sharding_specs.tnn_param_axes()


@dataclasses.dataclass(frozen=True)
class TNNLayer:
    """Static layer description; weights live in a (C, Q, rf_total) tensor."""

    n_columns: int
    rf_size: int
    n_neurons: int
    threshold: int
    t_steps: int
    dendrite: neuron.DendriteKind = "catwalk"
    k: int = 2
    w_max: int = 7
    #: receptive-field stride between adjacent columns; None = rf_size
    #: (disjoint windows). rf_stride < rf_size gives overlapping fields.
    rf_stride: Optional[int] = None
    #: recurrent input path: each column also sees its OWN Q post-WTA
    #: output lines from the previous gamma cycle, appended after the
    #: feedforward field, so weights become (C, Q, rf_size + Q). A silent
    #: carry makes the cycle exactly feedforward.
    recurrent: bool = False
    #: neuron-bank engine (:func:`repro_torch.core.neuron.fire_times_bank`).
    backend: neuron.Backend = "auto"
    #: compaction width for the sparse engines; None = measured.
    n_active_max: Optional[int] = None
    stdp: stdp.STDPConfig = dataclasses.field(default_factory=stdp.STDPConfig)
    #: minibatch STDP reduction: "mean" (default) or "sum".
    stdp_reduction: str = "mean"
    #: engine-selection policy for ``backend="auto"``; None = the default.
    policy: Optional[engine_policy.EnginePolicy] = None

    @property
    def stride(self) -> int:
        return self.rf_size if self.rf_stride is None else self.rf_stride

    @property
    def n_inputs(self) -> int:
        """Input lines the layer consumes (last window end-aligned)."""
        return self.stride * (self.n_columns - 1) + self.rf_size

    @property
    def n_outputs(self) -> int:
        """Output lines the layer produces (one per neuron, flattened)."""
        return self.n_columns * self.n_neurons

    @property
    def rf_total(self) -> int:
        """Dendritic inputs per neuron: rf_size + Q recurrent lines."""
        return self.rf_size + (self.n_neurons if self.recurrent else 0)

    def rf_index(self, device: Union[str, torch.device, None] = None
                 ) -> torch.Tensor:
        """(C, rf_size) int32 input-line ids per column, on ``device``
        (default: the card, :func:`resolve_device`)."""
        device = resolve_device(device)
        starts = torch.arange(self.n_columns, dtype=_I32,
                              device=device) * self.stride
        return starts[:, None] + torch.arange(self.rf_size, dtype=_I32,
                                              device=device)

    def neuron_config(self) -> neuron.NeuronConfig:
        return neuron.NeuronConfig(
            n_inputs=self.rf_total, threshold=self.threshold,
            t_steps=self.t_steps, dendrite=self.dendrite, k=self.k)

    def column_config(self):
        """Single-column view (for per-column tooling / equivalence tests)."""
        from repro_torch.core import column
        return column.ColumnConfig(
            n_inputs=self.rf_total, n_neurons=self.n_neurons,
            threshold=self.threshold, t_steps=self.t_steps,
            dendrite=self.dendrite, k=self.k, w_max=self.w_max,
            stdp=self.stdp, backend=self.backend)


def init_layer(generator: torch.Generator, cfg: TNNLayer,
               device: Union[str, torch.device, None] = None
               ) -> torch.Tensor:
    """Random initial weights (C, Q, rf_total) uniform over [0, w_max).

    Drawn on the CPU from ``generator`` (so a seed gives the same weights
    on every device) and moved to ``device`` (``None`` = ``cuda``)."""
    dev = resolve_device(device)
    w = torch.rand((cfg.n_columns, cfg.n_neurons, cfg.rf_total),
                   generator=generator, dtype=torch.float32)
    return (w * float(cfg.w_max)).to(dev)


def carry_init(cfg: TNNLayer, batch: int,
               device: Union[str, torch.device, None] = None) -> torch.Tensor:
    """All-silent recurrent carry ``(batch, n_outputs)`` for a layer: the
    previous-cycle output volley fed to a stream's first gamma cycle, on
    ``device`` (``None`` = ``cuda``; raises when CUDA is absent)."""
    return torch.full((batch, cfg.n_outputs), coding.NO_SPIKE, dtype=_I32,
                      device=resolve_device(device))


def stage_init(cfg: TNNLayer, batch: int,
               device: Union[str, torch.device, None] = None) -> torch.Tensor:
    """All-``NO_SPIKE`` pipeline stage buffer ``(batch, n_inputs)``: the
    inert warmup/drain input of gamma-cycle pipelining, on ``device``
    (``None`` = ``cuda``; raises when CUDA is absent)."""
    return torch.full((batch, cfg.n_inputs), coding.NO_SPIKE, dtype=_I32,
                      device=resolve_device(device))


def _gather_rf(volleys: torch.Tensor, cfg: TNNLayer,
               carry: Optional[torch.Tensor] = None,
               columns: slice = slice(None)) -> torch.Tensor:
    """(B, n_inputs) volleys -> (C, B, rf_total) per-column slices.

    For a recurrent layer, each column's slice is its feedforward window
    followed by that column's OWN Q previous-cycle output lines from
    ``carry`` (B, n_outputs); ``carry=None`` feeds the silent volley.
    ``columns`` keeps a range of columns (a rank's block under a mesh).
    """
    idx = cfg.rf_index(volleys.device)[columns].long()
    rf = volleys[:, idx].transpose(0, 1)              # (C, B, rf)
    if not cfg.recurrent:
        return rf
    b = volleys.shape[0]
    if carry is None:
        carry = carry_init(cfg, b, volleys.device)
    rec = carry.reshape(b, cfg.n_columns, cfg.n_neurons)[:, columns]
    rec = rec.transpose(0, 1)
    return torch.cat([rf, rec.to(rf.dtype)], dim=-1)  # (C, B, rf + Q)


class _Block(NamedTuple):
    """Where one rank's block of a layer call lies on a mesh: the resolved
    column and batch entries (``None`` = whole on every rank: replicated,
    or over axes of one rank), the rank's
    column and row ranges, and the whole ``(C, B, rf_total)`` stack."""

    col: sharding_specs.Axis
    dp: sharding_specs.Axis
    columns: slice
    rows: slice
    whole: Tuple[int, int, int]


def _block(cfg: TNNLayer, mesh, batch: int) -> _Block:
    """This rank's :class:`_Block` of a ``cfg`` call on ``batch`` volleys,
    derived once a (mesh, columns, batch, lines) and reused."""
    def make():
        col = sharding_specs.split(
            mesh, sharding_specs.tnn_param_pspec(mesh, cfg.n_columns)[0])
        dp = sharding_specs.split(
            mesh, sharding_specs.tnn_batch_pspec(mesh, batch)[0])
        return _Block(col, dp,
                      sharding_specs.block_slice(mesh, cfg.n_columns, col),
                      sharding_specs.block_slice(mesh, batch, dp),
                      (cfg.n_columns, batch, cfg.rf_total))
    return sharding_specs.memo(
        mesh, ("layer", cfg.n_columns, batch, cfg.rf_total), make)


def _forward_block(weights: torch.Tensor, x: torch.Tensor, cfg: TNNLayer,
                   carry: Optional[torch.Tensor], mesh, batch: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One gamma cycle of this rank's rows ``x`` (B_local, n_inputs) of a
    whole batch of ``batch`` volleys, with all of the carry's lines for
    those rows: :func:`_fire_block` on the receptive fields of its
    columns. The callers check the weights' block once, at their entry.
    Returns ``(out (B_local, C, Q), winners (B_local, C))``."""
    blk = _block(cfg, mesh, batch)
    return _fire_block(weights, _gather_rf(x, cfg, carry, blk.columns),
                       cfg, mesh, blk)


def _fire_block(weights: torch.Tensor, times_rf: torch.Tensor,
                cfg: TNNLayer, mesh, blk: _Block
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bank and the 1-WTA on this rank's ``(C_local, B_local, rft)``
    receptive fields, then the post-WTA outputs all-gathered over the
    ``column`` group (skipped where the columns are whole on every
    rank)."""
    out, winners = _fire_and_inhibit(weights, times_rf, cfg, mesh,
                                     blk.whole)
    if blk.col is not None:
        # one gather for both: winners ride as an extra lane
        both = torch.cat([out, winners[..., None]], dim=-1)
        both = sharding_specs.gather(both, (None, blk.col, None), mesh)
        out, winners = both[..., :-1], both[..., -1]
    return out, winners


def _gather_rows(tensors: Sequence[torch.Tensor], dp, mesh
                 ) -> List[torch.Tensor]:
    """All-gather each tensor's rows (dim 0) over the DP entry ``dp`` in
    one collective; the tensors as they are when ``dp`` is None."""
    if dp is None:
        return list(tensors)
    flat = [t.reshape(t.shape[0], -1) for t in tensors]
    both = sharding_specs.gather(torch.cat(flat, dim=1), (dp, None), mesh)
    out, col = [], 0
    for t, f in zip(tensors, flat):
        out.append(both[:, col:col + f.shape[1]].reshape(
            (both.shape[0],) + tuple(t.shape[1:])))
        col += f.shape[1]
    return out


def layer_input_density(volleys: torch.Tensor, cfg: TNNLayer,
                        carry: Optional[torch.Tensor] = None) -> float:
    """Measured fraction of contributing lines across the layer's
    receptive fields (host diagnostic; shared lines count once per
    column)."""
    v = volleys[None, :] if volleys.dim() == 1 else volleys
    if carry is not None and carry.dim() == 1:
        carry = carry[None, :]
    return compaction.measured_density(_gather_rf(v, cfg, carry),
                                       cfg.t_steps)


def layer_forward(weights: torch.Tensor, volleys: torch.Tensor,
                  cfg: TNNLayer, carry: Optional[torch.Tensor] = None, *,
                  mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run one gamma cycle for a batch of volleys.

    Args:
      weights: (C, Q, rf_total) float; rounded to ints (half to even).
        Under ``mesh``, this rank's block (``specs.tnn_param_pspec``).
      volleys: (B, n_inputs) int32 spike volleys — or (n_inputs,) for one.
      carry: previous-cycle output volley (B, n_outputs) int32 for a
        recurrent layer (1-D for a single volley); None = silent carry.
        Must be None for a non-recurrent layer.
      mesh: a ``("data", "column")`` mesh; every rank passes the whole
        volleys and carry and gets the whole outputs back.

    Returns:
      (out_times, winners): out_times (B, C, Q) int32 post-WTA spike times
      (NO_SPIKE for losers); winners (B, C) int32 per-column winner index,
      -1 where no neuron in the column fired. 1-D input gives (C, Q)/(C,).
    """
    if carry is not None and not cfg.recurrent:
        raise ValueError("carry given for a non-recurrent layer")
    single = volleys.dim() == 1
    if single:
        volleys = volleys[None, :]
        if carry is not None and carry.dim() == 1:
            carry = carry[None, :]
    volleys = volleys.to(_I32)
    b = volleys.shape[0]
    if mesh is not None:
        sharding_specs.maybe_wsc(weights, *_PARAM, mesh=mesh,
                                 shape=(cfg.n_columns, cfg.n_neurons,
                                        cfg.rf_total))
        blk = _block(cfg, mesh, b)
        out, winners = _forward_block(
            weights, volleys[blk.rows], cfg,
            None if carry is None else carry[blk.rows], mesh, b)
        out, winners = _gather_rows([out, winners], blk.dp, mesh)
    else:
        times_rf = _gather_rf(volleys, cfg, carry)           # (C, B, rft)
        out, winners = _fire_and_inhibit(weights, times_rf, cfg)
    # whole on every rank
    out = sharding_specs.maybe_wsc(out, None, None, None, mesh=mesh,
                                   shape=(b, cfg.n_columns, cfg.n_neurons))
    if single:
        return out[0], winners[0]
    return out, winners


def _fire_and_inhibit(weights: torch.Tensor, times_rf: torch.Tensor,
                      cfg: TNNLayer, mesh=None,
                      whole: Optional[Tuple[int, int, int]] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The neuron bank and 1-WTA on gathered ``(C, B, rf_total)`` slices
    (under ``mesh``, this rank's block of a ``whole`` stack); returns
    ``(out (B, C, Q), winners (B, C))``."""
    w_int = torch.round(weights).to(_I32)
    fire = neuron.fire_times_bank(times_rf, w_int, cfg.neuron_config(),
                                  backend=cfg.backend,
                                  n_active_max=cfg.n_active_max,
                                  policy=cfg.policy, mesh=mesh,
                                  shape=whole)                 # (C, B, Q)
    fire = fire.transpose(0, 1)                               # (B, C, Q)
    # 1-WTA: the first (lowest-index) neuron at the earliest fire time
    lane = torch.arange(cfg.n_neurons, dtype=_I32, device=fire.device)
    earliest = fire.amin(dim=-1, keepdim=True)
    first = torch.where(fire == earliest, lane, cfg.n_neurons).amin(dim=-1)
    any_fire = earliest[..., 0] < coding.NO_SPIKE
    winners = torch.where(any_fire, first, -1).to(_I32)
    out = torch.where(lane == winners[..., None], fire, coding.NO_SPIKE)
    return out.to(_I32), winners


def layer_step(weights: torch.Tensor, volleys: torch.Tensor, cfg: TNNLayer,
               key: Optional[torch.Generator] = None,
               carry: Optional[torch.Tensor] = None, *,
               draws: Optional[torch.Tensor] = None, mesh=None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forward + minibatch STDP. Returns (new_weights, out_times, winners).

    The forward runs at the pre-step weights; per-volley STDP deltas are
    evaluated at those weights and accumulated across the batch
    (``cfg.stdp_reduction``), every column at once, each learning only
    from its own receptive-field slice and WTA outcome. For a recurrent
    layer the STDP slice includes the carry lines, so the recurrent weight
    columns learn under the same rule as the feedforward ones. A 1-D
    volley is promoted to a batch of one (outputs keep that batch dim).

    ``key`` (a ``torch.Generator`` on the weights' device) selects the
    stochastic rule and draws its uniforms in one ``torch.rand`` of shape
    ``(C, B, Q, rf_total)``; ``draws`` hands in that tensor instead;
    neither selects the expectation rule.

    Under ``mesh`` the weights in and out are this rank's block and the
    volleys, carry, outputs and ``draws`` whole. Each rank fires its rows
    of its columns, the post-WTA outputs are all-gathered over the
    ``column`` and ``data`` groups, and each rank updates its own columns
    from the whole minibatch. The stochastic rule's uniforms are drawn
    for the whole stack from ``key``, the same on every rank, and cut to
    the rank's columns. The B-way reduction adds in an order set by B
    alone (``stdp.stdp_update_column_minibatch``), so the new weights are
    the single-device ones, bit for bit.
    """
    if carry is not None and not cfg.recurrent:
        raise ValueError("carry given for a non-recurrent layer")
    if volleys.dim() == 1:
        volleys = volleys[None, :]
        if carry is not None and carry.dim() == 1:
            carry = carry[None, :]
    volleys = volleys.to(_I32)
    if mesh is None:
        times_rf = _gather_rf(volleys, cfg, carry)           # (C, B, rft)
        out_times, winners = _fire_and_inhibit(weights, times_rf, cfg)
        new_w = stdp.stdp_update_column_minibatch(
            weights, times_rf, out_times.transpose(0, 1),
            winners.transpose(0, 1), cfg.stdp, key,
            reduction=cfg.stdp_reduction, draws=draws)
        return new_w, out_times, winners
    whole_w = (cfg.n_columns, cfg.n_neurons, cfg.rf_total)
    sharding_specs.maybe_wsc(weights, *_PARAM, mesh=mesh, shape=whole_w)
    b = volleys.shape[0]
    blk = _block(cfg, mesh, b)
    # its columns' receptive fields for every row: the STDP reads them all
    times_rf = _gather_rf(volleys, cfg, carry, blk.columns)  # (C_l, B, rft)
    out, winners = _fire_block(weights, times_rf[:, blk.rows], cfg, mesh,
                               blk)
    out_times, winners = _gather_rows([out, winners], blk.dp, mesh)
    u = stdp.uniforms((cfg.n_columns, b) + whole_w[1:], weights, key, draws)
    new_w = stdp.stdp_update_column_minibatch(
        weights, times_rf, out_times[:, blk.columns].transpose(0, 1),
        winners[:, blk.columns].transpose(0, 1), cfg.stdp,
        reduction=cfg.stdp_reduction,
        draws=None if u is None else u[blk.columns])
    new_w = sharding_specs.maybe_wsc(new_w, *_PARAM, mesh=mesh,
                                     shape=whole_w)
    return new_w, out_times, winners


def scan_minibatches(step_fn: Callable, carry, volleys: torch.Tensor,
                     batch_size: int, key: Optional[torch.Generator],
                     draws: Optional[Sequence] = None):
    """Stream-batching scaffold shared by train_layer / train_network.

    Splits a (M, n) volley stream into M // batch_size sequential
    minibatches (M must be divisible) and runs
    ``step_fn(carry, batch, key, step_draws) -> (carry, ys)`` over them in
    order; returns ``(carry, ys stacked over steps)`` (a tuple ``ys`` is
    stacked entry by entry). A generator ``key`` is handed to every step,
    which draws from it in turn; ``draws[i]`` are step i's uniforms.
    """
    m = volleys.shape[0]
    if m % batch_size != 0:
        raise ValueError(f"stream length {m} not divisible by "
                         f"batch_size {batch_size}")
    steps = m // batch_size
    if draws is not None and len(draws) != steps:
        raise ValueError(f"draws for {len(draws)} steps, stream of "
                         f"{steps} minibatches")
    batches = volleys.reshape(steps, batch_size, volleys.shape[-1])
    ys = []
    for i in range(steps):
        carry, y = step_fn(carry, batches[i], key,
                           None if draws is None else draws[i])
        ys.append(y)
    if ys and isinstance(ys[0], tuple):
        return carry, tuple(torch.stack(col) for col in zip(*ys))
    return carry, torch.stack(ys)


# repro-lint: unplaced (single-device layer; multi-GPU columns come later)
def train_layer(weights: torch.Tensor, volleys: torch.Tensor, cfg: TNNLayer,
                batch_size: int = 1, key: Optional[torch.Generator] = None,
                *, draws: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Train over a stream of volleys (M, n_inputs).

    The stream is processed as M // batch_size sequential minibatches
    (M must be divisible); batch_size=1 is the classic online rule.
    ``draws`` ((M // batch_size, C, batch_size, Q, rf_total)) hands in the
    stochastic rule's uniforms for the whole stream.

    Returns (final_weights, winners (M, C)).
    """

    def step(w, batch, sk, sd):
        new_w, _, winners = layer_step(w, batch, cfg, sk, draws=sd)
        return new_w, winners

    final_w, winners = scan_minibatches(step, weights, volleys, batch_size,
                                        key, draws)
    return final_w, winners.reshape(volleys.shape[0], cfg.n_columns)
