"""Temporal / unary coding utilities (paper §II, Fig. 3).

TNNs encode a value in the *timing* of a single spike within a gamma cycle
of ``T`` clock ticks. Earlier spike = stronger input. ``NO_SPIKE`` (= value
infinity) means the line stays silent. Spike times are int32 tensors with
entries in ``[0, T)`` or ``NO_SPIKE``.
"""

from __future__ import annotations

from typing import Optional

import torch

#: Sentinel spike time for "no spike" (value = infinity). Any time >= T
#: behaves identically; a large int32 that survives +w arithmetic.
NO_SPIKE = 2**30


def is_spike(times: torch.Tensor) -> torch.Tensor:
    """Boolean mask of lines that carry a spike."""
    return times < NO_SPIKE


def value_to_time(values: torch.Tensor, t_max: int) -> torch.Tensor:
    """Encode intensities in [0, 1] as spike times: strongest -> t=0,
    zero intensity -> no spike (larger value == earlier spike)."""
    values = values.clamp(0.0, 1.0)
    t = torch.round((1.0 - values) * (t_max - 1)).to(torch.int32)
    return torch.where(values <= 0.0, torch.full_like(t, NO_SPIKE), t)


def time_to_value(times: torch.Tensor, t_max: int) -> torch.Tensor:
    """Inverse of :func:`value_to_time` (no-spike -> 0)."""
    v = 1.0 - times.to(torch.float32) / (t_max - 1)
    return torch.where(is_spike(times), v, torch.zeros_like(v))


def _linspace(v_min: float, v_max: float, n: int,
              device: torch.device) -> torch.Tensor:
    """float32 ``linspace`` with the reference package's rounding
    (``start * (1 - step) + stop * step``, endpoint appended exactly), so
    the field centers agree bit for bit."""
    if n == 1:
        return torch.full((1,), v_min, dtype=torch.float32, device=device)
    div = n - 1
    step = torch.arange(div, dtype=torch.float32, device=device) / div
    start = torch.tensor(v_min, dtype=torch.float32, device=device)
    stop = torch.tensor(v_max, dtype=torch.float32, device=device)
    out = start * (1 - step) + stop * step
    return torch.cat([out, stop.reshape(1)])


def grf_encode(values: torch.Tensor, n_fields: int, t_max: int,
               v_min: float = 0.0, v_max: float = 1.0,
               sigma: Optional[float] = None,
               cutoff: float = 0.05) -> torch.Tensor:
    """Gaussian receptive field population coding (Bohte et al. 2002).

    Each scalar is covered by ``n_fields`` overlapping Gaussian fields with
    centers evenly spaced over ``[v_min, v_max]``; field j's activation
    ``exp(-(v - c_j)^2 / 2 sigma^2)`` becomes a spike time via
    :func:`value_to_time`. Activations below ``cutoff`` stay silent.

    Args:
      values: (..., d) float features.
      n_fields: receptive fields per scalar.
      t_max: gamma-cycle length for the time code.
      v_min, v_max: feature range the field centers span.
      sigma: field width; default 0.8x the center spacing.
      cutoff: activations below this encode as NO_SPIKE.

    Returns:
      (..., d, n_fields) int32 spike times.
    """
    values = torch.as_tensor(values, dtype=torch.float32)
    centers = _linspace(v_min, v_max, n_fields, values.device)
    if sigma is None:
        sigma = 0.8 * (v_max - v_min) / max(n_fields - 1, 1)
    act = torch.exp(-0.5 * ((values[..., None] - centers) / sigma) ** 2)
    act = torch.where(act < cutoff, torch.zeros_like(act), act)
    return value_to_time(act, t_max)


def rnl_response(w: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Equation (1): the ramp-no-leak response value at relative time t.

    rho(w, t) = 0 if t < 0; t + 1 if 0 <= t < w; w if t >= w.
    """
    resp = torch.minimum(t + 1, w)
    return torch.where(t < 0, torch.zeros_like(resp), resp).to(torch.int32)


# repro-lint: unplaced (encoding primitive; single device)
def rnl_response_bits(times: torch.Tensor, weights: torch.Tensor,
                      t_steps: int) -> torch.Tensor:
    """Per-cycle dendrite bits: line ``i`` is hot at tick ``t`` iff
    ``times[i] <= t < times[i] + weights[i]``.

    Args:
      times:   (..., n) int32 spike times (NO_SPIKE for silent lines).
      weights: (..., n) or (n,) int32 synaptic weights >= 0.
      t_steps: gamma-cycle length in ticks.

    Returns:
      (..., t_steps, n) bool.
    """
    t = torch.arange(t_steps, dtype=torch.int32, device=times.device)[:, None]
    start = times[..., None, :]
    end = start + torch.broadcast_to(weights, times.shape)[..., None, :]
    return (t >= start) & (t < end)


def times_to_monotone_wave(times: torch.Tensor,
                           t_steps: int) -> torch.Tensor:
    """Leading-0 rising-edge unary wave: ``wave[..., t, i] = (t >= times[i])``.

    The signal form unary CAS networks consume (Fig. 3): the rising edge's
    timing carries the value; OR = earlier edge = larger value.

    Returns:
      ``times.shape[:-1] + (t_steps, n)`` bool.
    """
    t = torch.arange(t_steps, dtype=torch.int32, device=times.device)
    return t[:, None] >= times[..., None, :]


def popcount_thermometer(bits: torch.Tensor) -> torch.Tensor:
    """The sorted form of a Boolean vector: the bottom ``popcount`` wires
    hot, ``thermo[..., m] = m >= n - popcount(bits)``. A correct unary
    sorting network applied bitwise produces exactly this (0-1 principle).
    """
    n = bits.shape[-1]
    pc = bits.sum(dim=-1, keepdim=True, dtype=torch.int32)
    idx = torch.arange(n, dtype=torch.int32, device=bits.device)
    return idx >= (n - pc)
