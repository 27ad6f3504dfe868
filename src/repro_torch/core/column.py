"""TNN column: n inputs -> q parallel SRM0-RNL neurons -> 1-WTA inhibition.

The unit of computation in Smith-style TNNs ([12, 13]). A column receives
one spike volley per gamma cycle, every neuron integrates it through its own
synaptic weights, and winner-take-all lateral inhibition lets only the
earliest-firing neuron emit a spike (ties broken by lowest neuron index, the
hardware priority encoder). With STDP this performs online unsupervised
clustering: each neuron's weight vector converges to a cluster centroid of
the input volleys.

The forward pass is one :func:`repro_torch.core.neuron.fire_times_bank`
call on a 2-D bank, so on a CUDA device with ``backend="auto"`` each gamma
cycle is one launch of the single-bank kernel
(:func:`repro_torch.kernels.rnl_neuron.rnl_fire_times`). For many columns
or batched volleys use :mod:`repro_torch.core.layer`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from repro_torch.core import coding, neuron, stdp
from repro_torch.kernels.common import resolve_device

_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class ColumnConfig:
    n_inputs: int
    n_neurons: int
    threshold: int
    t_steps: int
    dendrite: neuron.DendriteKind = "catwalk"
    k: int = 2
    w_max: int = 7
    stdp: stdp.STDPConfig = dataclasses.field(default_factory=stdp.STDPConfig)
    #: neuron-bank engine (see repro_torch.core.neuron.fire_times_bank);
    #: "auto" = the fused kernel on CUDA, the policy's pick elsewhere.
    backend: neuron.Backend = "auto"

    def neuron_config(self) -> neuron.NeuronConfig:
        return neuron.NeuronConfig(
            n_inputs=self.n_inputs, threshold=self.threshold,
            t_steps=self.t_steps, dendrite=self.dendrite, k=self.k)


def init_column(generator: torch.Generator, cfg: ColumnConfig,
                device: Union[str, torch.device, None] = None
                ) -> torch.Tensor:
    """Random initial weights (q, n) uniform over [0, w_max).

    Drawn on the CPU from ``generator`` (so a seed gives the same weights
    on every device) and moved to ``device`` (``None`` = ``cuda``; raises
    when CUDA is absent)."""
    dev = resolve_device(device)
    w = torch.rand((cfg.n_neurons, cfg.n_inputs), generator=generator,
                   dtype=torch.float32)
    return (w * float(cfg.w_max)).to(dev)


# repro-lint: unplaced (single-bank column; layers carry the placement)
def column_forward(weights: torch.Tensor, in_times: torch.Tensor,
                   cfg: ColumnConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run one gamma cycle.

    Args:
      weights: (q, n) float; rounded to ints (hardware registers).
      in_times: (n,) int32 spike volley.

    Returns:
      (out_times, winner): out_times (q,) int32 post-WTA spike times
      (NO_SPIKE for losers); winner () int32 index, -1 if no neuron fired.
    """
    w_int = torch.round(weights).to(_I32)
    fire = neuron.fire_times_bank(in_times[None, :].to(_I32), w_int,
                                  cfg.neuron_config(),
                                  backend=cfg.backend)[0]
    # 1-WTA: earliest fire wins; ties -> lowest index, because argmin
    # returns the first minimal entry (hardware priority encoder).
    any_fire = coding.is_spike(fire).any()
    winner = torch.where(any_fire, torch.argmin(fire).to(_I32), -1)
    lane = torch.arange(fire.shape[0], dtype=_I32, device=fire.device)
    out = torch.where(lane == winner, fire, coding.NO_SPIKE).to(_I32)
    return out, winner.to(_I32)


# repro-lint: unplaced (single-bank column; layers carry the placement)
def column_step(weights: torch.Tensor, in_times: torch.Tensor,
                cfg: ColumnConfig, key: Optional[torch.Generator] = None,
                *, draws: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forward + STDP. Returns (new_weights, out_times, winner).

    ``key`` (a generator) or ``draws`` ((q, n) uniforms) selects the
    stochastic rule; neither selects the expectation rule."""
    out_times, winner = column_forward(weights, in_times, cfg)
    new_w = stdp.stdp_update_column(weights, in_times, out_times, winner,
                                    cfg.stdp, key, draws=draws)
    return new_w, out_times, winner


# repro-lint: unplaced (single-bank column; layers carry the placement)
def train_column(weights: torch.Tensor, volleys: torch.Tensor,
                 cfg: ColumnConfig, key: Optional[torch.Generator] = None,
                 *, draws: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Online training over a stream of volleys (m, n), one
    :func:`column_step` per volley. ``key`` draws each step's uniforms in
    turn; ``draws`` ((m, q, n)) hands them in for the whole stream.

    Returns (final_weights, winners (m,)).
    """
    if draws is not None and draws.shape[0] != volleys.shape[0]:
        raise ValueError(f"draws for {draws.shape[0]} steps, stream of "
                         f"{volleys.shape[0]} volleys")
    w = weights
    winners = []
    for i in range(volleys.shape[0]):
        w, _, winner = column_step(
            w, volleys[i], cfg, key,
            draws=None if draws is None else draws[i])
        winners.append(winner)
    if not winners:
        return w, torch.empty((0,), dtype=_I32, device=weights.device)
    return w, torch.stack(winners)


def cluster_purity(winners: torch.Tensor, labels: torch.Tensor,
                   n_neurons: int, n_classes: int) -> torch.Tensor:
    """Unsupervised clustering purity: assign each neuron its majority
    label, score the fraction of volleys routed to a matching neuron."""
    winners = torch.as_tensor(winners)
    labels = torch.as_tensor(labels, device=winners.device).long()
    conf = torch.zeros((n_neurons + 1, n_classes), dtype=torch.int64,
                       device=winners.device)        # row q = no-win
    idx = torch.where(winners >= 0, winners, n_neurons).long()
    conf.index_put_((idx, labels), torch.ones_like(idx), accumulate=True)
    per_neuron_best = conf[:n_neurons].amax(dim=1)
    return per_neuron_best.sum() / max(1, winners.shape[0])
