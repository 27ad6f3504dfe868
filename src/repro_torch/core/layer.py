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

Weights are (C, Q, rf_total) float tensors, rounded to int32 at use.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

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
    w_int = torch.round(weights).to(_I32)
    times_rf = _gather_rf(volleys.to(_I32), cfg, carry)      # (C, B, rft)
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
    out = out.to(_I32)
    if single:
        return out[0], winners[0]
    return out, winners
