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
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core import coding, compaction, neuron, stdp
from repro_torch.core import policy as engine_policy
from repro_torch.kernels.common import resolve_device

_I32 = torch.int32


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
               carry: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, n_inputs) volleys -> (C, B, rf_total) per-column slices.

    For a recurrent layer, each column's slice is its feedforward window
    followed by that column's OWN Q previous-cycle output lines from
    ``carry`` (B, n_outputs); ``carry=None`` feeds the silent volley.
    """
    idx = cfg.rf_index(volleys.device).long()
    rf = volleys[:, idx].transpose(0, 1)              # (C, B, rf)
    if not cfg.recurrent:
        return rf
    b = volleys.shape[0]
    if carry is None:
        carry = carry_init(cfg, b, volleys.device)
    rec = carry.reshape(b, cfg.n_columns, cfg.n_neurons).transpose(0, 1)
    return torch.cat([rf, rec.to(rf.dtype)], dim=-1)  # (C, B, rf + Q)


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


# repro-lint: unplaced (single-device layer; multi-GPU columns come later)
def layer_forward(weights: torch.Tensor, volleys: torch.Tensor,
                  cfg: TNNLayer, carry: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run one gamma cycle for a batch of volleys.

    Args:
      weights: (C, Q, rf_total) float; rounded to ints (half to even).
      volleys: (B, n_inputs) int32 spike volleys — or (n_inputs,) for one.
      carry: previous-cycle output volley (B, n_outputs) int32 for a
        recurrent layer (1-D for a single volley); None = silent carry.
        Must be None for a non-recurrent layer.

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
    times_rf = _gather_rf(volleys.to(_I32), cfg, carry)      # (C, B, rft)
    out, winners = _fire_and_inhibit(weights, times_rf, cfg)
    if single:
        return out[0], winners[0]
    return out, winners


def _fire_and_inhibit(weights: torch.Tensor, times_rf: torch.Tensor,
                      cfg: TNNLayer) -> Tuple[torch.Tensor, torch.Tensor]:
    """The neuron bank and 1-WTA on gathered ``(C, B, rf_total)`` slices;
    returns ``(out (B, C, Q), winners (B, C))``."""
    w_int = torch.round(weights).to(_I32)
    fire = neuron.fire_times_bank(times_rf, w_int, cfg.neuron_config(),
                                  backend=cfg.backend,
                                  n_active_max=cfg.n_active_max,
                                  policy=cfg.policy)           # (C, B, Q)
    fire = fire.transpose(0, 1)                               # (B, C, Q)
    # 1-WTA: the first (lowest-index) neuron at the earliest fire time
    lane = torch.arange(cfg.n_neurons, dtype=_I32, device=fire.device)
    earliest = fire.amin(dim=-1, keepdim=True)
    first = torch.where(fire == earliest, lane, cfg.n_neurons).amin(dim=-1)
    any_fire = earliest[..., 0] < coding.NO_SPIKE
    winners = torch.where(any_fire, first, -1).to(_I32)
    out = torch.where(lane == winners[..., None], fire, coding.NO_SPIKE)
    return out.to(_I32), winners


# repro-lint: unplaced (single-device layer; multi-GPU columns come later)
def layer_step(weights: torch.Tensor, volleys: torch.Tensor, cfg: TNNLayer,
               key: Optional[torch.Generator] = None,
               carry: Optional[torch.Tensor] = None, *,
               draws: Optional[torch.Tensor] = None
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
    """
    if carry is not None and not cfg.recurrent:
        raise ValueError("carry given for a non-recurrent layer")
    if volleys.dim() == 1:
        volleys = volleys[None, :]
        if carry is not None and carry.dim() == 1:
            carry = carry[None, :]
    times_rf = _gather_rf(volleys.to(_I32), cfg, carry)      # (C, B, rft)
    out_times, winners = _fire_and_inhibit(weights, times_rf, cfg)
    new_w = stdp.stdp_update_column_minibatch(
        weights, times_rf, out_times.transpose(0, 1),
        winners.transpose(0, 1), cfg.stdp, key,
        reduction=cfg.stdp_reduction, draws=draws)
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
