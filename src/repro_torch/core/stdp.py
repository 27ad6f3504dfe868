"""Spike-timing-dependent plasticity for TNN columns (Smith [12, 13]).

The TNN STDP rule is a local, unsupervised update applied per synapse after
each gamma cycle, based only on whether/when the input line (x) and the
neuron's output (y, post-WTA) spiked:

  case                         update
  ---------------------------  -----------------------------
  x spike, y spike, t_x <= t_y  capture:  w += mu_capture * B
  x spike, y spike, t_x >  t_y  backoff:  w -= mu_backoff * B
  x spike, no y spike           search:   w += mu_search
  no x spike, y spike           backoff:  w -= mu_backoff * B
  no x, no y                    no change

with B a stabilizing Bernoulli variable that slows drift near the weight
rails, P(B=1) = max(4 (w/w_max)(1 - w/w_max), floor). ``key=None`` selects
the deterministic expectation rule (B replaced by its probability); a
``torch.Generator`` on the weights' device selects the stochastic rule.
The stochastic rule compares uniforms in [0, 1) against B's probability;
``draws=`` hands those uniforms in ready-made (the same tensor a generator
would fill), which is how a caller replays or imports a stream of draws.
Weights are float tensors in [0, w_max], rounded on readout.

Every function here is a plain function on tensors that broadcasts over
leading dimensions (neurons, volleys, columns), with the reference's
arithmetic order kept term for term: fused ops such as ``addcmul`` round
differently and are not used.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import torch

from repro_torch.core import coding

_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class STDPConfig:
    w_max: int = 7
    mu_capture: float = 1.0
    mu_backoff: float = 0.5
    mu_search: float = 0.25
    #: stabilization: scale updates by 4*(w/wmax)*(1-w/wmax) + floor
    stabilize: bool = True
    stab_floor: float = 0.25


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d``, divided and rounded once on every device. A Python-number
    divisor on a CUDA tensor is applied as a product with its reciprocal,
    which rounds differently in the last bit; a 0-dim tensor on the same
    device is divided exactly, as on the CPU."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def _stabilizer(w: torch.Tensor, cfg: STDPConfig) -> torch.Tensor:
    if not cfg.stabilize:
        return torch.ones_like(w)
    u = _div(w, cfg.w_max)
    return torch.clamp(4.0 * u * (1.0 - u), min=cfg.stab_floor)


def uniforms(shape: Sequence[int], like: torch.Tensor,
              key: Optional[torch.Generator],
              draws: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The stochastic rule's uniforms of ``shape``: ``draws`` as given
    (checked), or one ``torch.rand`` from ``key`` on ``like``'s device;
    ``None`` for the expectation rule."""
    if key is not None and draws is not None:
        raise ValueError("pass a generator or draws, not both")
    if draws is not None:
        if tuple(draws.shape) != tuple(shape):
            raise ValueError(f"draws of shape {tuple(draws.shape)}, "
                             f"expected {tuple(shape)}")
        return draws.to(device=like.device, dtype=like.dtype)
    if key is not None:
        return torch.rand(tuple(shape), generator=key, device=like.device,
                          dtype=like.dtype)
    return None


def batch_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` in an order set by that dim's size alone: halves
    added pairwise, an odd row carried to the next round. Every add is
    elementwise, so each element rounds alike whatever the other dims
    hold (a block of the columns or all of them) and on every device,
    where ``torch.sum`` picks its order by the tensor's sizes and
    strides."""
    x = x.movedim(dim, 0)
    if x.shape[0] == 0:
        return x.sum(0)
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        pairs = x[:half] + x[half:2 * half]
        x = torch.cat([pairs, x[2 * half:]]) if x.shape[0] % 2 else pairs
    return x[0]


def _i32(t: Union[int, torch.Tensor], like: torch.Tensor
              ) -> torch.Tensor:
    return torch.as_tensor(t, dtype=_I32, device=like.device)


# repro-lint: unplaced (per-neuron rule, broadcast over neurons/volleys)
def stdp_delta(weights: torch.Tensor, in_times: torch.Tensor,
               out_time: Union[int, torch.Tensor], cfg: STDPConfig,
               key: Optional[torch.Generator] = None, *,
               draws: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Raw (unclipped) STDP weight delta.

    The delta form is the building block for minibatch accumulation
    (:func:`stdp_update_column_minibatch`): per-volley deltas are computed
    at a shared starting weight, reduced over the batch, and clipped once.

    Args:
      weights:  (..., n) float in [0, w_max].
      in_times: (..., n) int32 input spike times (NO_SPIKE if silent),
        broadcast against ``weights``.
      out_time: (...) int32 output spike time after WTA (NO_SPIKE if the
        neuron did not win / did not fire — then only 'search' applies).
      key: generator for the stochastic rule; None = expectation.
      draws: the stochastic rule's uniforms in [0, 1), shaped like the
        delta, in place of ``key``.
    """
    t_in = _i32(in_times, weights)
    t_out = _i32(out_time, weights)[..., None]
    x = coding.is_spike(t_in)
    y = coding.is_spike(t_out)
    causal = x & y & (t_in <= t_out)
    anti = x & y & (t_in > t_out)
    search = x & ~y
    ghost = ~x & y

    b = _stabilizer(weights, cfg)
    shape = torch.broadcast_shapes(weights.shape, t_in.shape, t_out.shape)
    u = uniforms(shape, weights, key, draws)
    if u is not None:
        b = (u < b).to(weights.dtype)

    return (causal * cfg.mu_capture * b
            - anti * cfg.mu_backoff * b
            + search * cfg.mu_search
            - ghost * cfg.mu_backoff * b)


# repro-lint: unplaced (per-neuron rule, broadcast over neurons/volleys)
def stdp_update(weights: torch.Tensor, in_times: torch.Tensor,
                out_time: Union[int, torch.Tensor], cfg: STDPConfig,
                key: Optional[torch.Generator] = None, *,
                draws: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One STDP step (see :func:`stdp_delta` for args).

    Returns updated weights, clipped to [0, w_max].
    """
    return torch.clamp(weights + stdp_delta(weights, in_times, out_time,
                                            cfg, key, draws=draws),
                       0.0, float(cfg.w_max))


def _keep(winner: Union[int, torch.Tensor], q: int,
          like: torch.Tensor) -> torch.Tensor:
    """(..., q) mask of the neurons that learn: the WTA winner, or every
    neuron when the column stayed silent (winner -1)."""
    win = _i32(winner, like)[..., None]
    idx = torch.arange(q, dtype=_I32, device=like.device)
    return (idx == win) | (win < 0)


# repro-lint: unplaced (per-column rule, broadcast over columns)
def stdp_update_column(weights: torch.Tensor, in_times: torch.Tensor,
                       out_times: torch.Tensor,
                       winner: Union[int, torch.Tensor], cfg: STDPConfig,
                       key: Optional[torch.Generator] = None, *,
                       draws: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Column-level STDP with lateral inhibition of learning.

    Only the WTA winner learns from its (capture/backoff) table — the
    inhibited losers neither fired nor learn, mirroring the post-WTA STDP
    datapath of the RTL implementations [7]. When NO neuron fired
    (winner == -1), every neuron applies the 'search' rule on spiking
    inputs so the column can acquire unseen patterns.

    Args: weights (..., q, n); in_times (..., n); out_times (..., q);
    winner (...); draws (..., q, n) uniforms in place of ``key``.
    """
    t_in = _i32(in_times, weights)[..., None, :]
    shape = torch.broadcast_shapes(weights.shape, t_in.shape)
    u = uniforms(shape, weights, key, draws)
    updated = stdp_update(weights, t_in, out_times, cfg, draws=u)
    keep = _keep(winner, weights.shape[-2], weights)
    return torch.where(keep[..., None], updated, weights)


# repro-lint: unplaced (per-column rule, broadcast over columns)
def stdp_update_column_minibatch(weights: torch.Tensor,
                                 in_times: torch.Tensor,
                                 out_times: torch.Tensor,
                                 winner: torch.Tensor, cfg: STDPConfig,
                                 key: Optional[torch.Generator] = None,
                                 reduction: str = "mean", *,
                                 draws: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """Minibatch STDP for a column over a batch of B volleys.

    Each volley's delta is evaluated at the *shared* starting weights with
    the same winner/silent masking as :func:`stdp_update_column`, the B
    deltas are reduced (mean by default; "sum" accumulates raw; summed by
    :func:`batch_sum`, so a block of the columns gets the whole stack's
    values), and the result is applied and clipped once. At B=1 with
    ``key=None`` this is bit-identical to :func:`stdp_update_column`. The
    stochastic rule draws independent uniforms per (volley, neuron,
    line): one ``torch.rand`` of shape (..., B, q, n).

    Args:
      weights:   (..., q, n) float — a leading C runs C columns at once.
      in_times:  (..., B, n) int32 input volleys.
      out_times: (..., B, q) int32 post-WTA output spike times.
      winner:    (..., B) int32 winner index per volley (-1 = silent).
      reduction: "mean" (batch-size-invariant step scale) or "sum".
      draws:     (..., B, q, n) uniforms in place of ``key``.
    """
    if reduction not in ("mean", "sum"):
        raise ValueError(f"unknown reduction {reduction!r}")
    bsz, q = out_times.shape[-2], weights.shape[-2]
    t_in = _i32(in_times, weights)
    shape = tuple(t_in.shape[:-1]) + tuple(weights.shape[-2:])
    u = uniforms(shape, weights, key, draws)
    deltas = stdp_delta(weights[..., None, :, :], t_in[..., :, None, :],
                        out_times, cfg, draws=u)            # (..., B, q, n)
    keep = _keep(winner, q, weights)                        # (..., B, q)
    deltas = torch.where(keep[..., None], deltas, 0.0)
    acc = batch_sum(deltas, dim=-3)
    if reduction == "mean":
        acc = _div(acc, bsz)
    return torch.clamp(weights + acc, 0.0, float(cfg.w_max))
