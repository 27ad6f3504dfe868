"""Spike compaction: relocate active lines into a dense prefix.

Per volley, gather the lines that can contribute during the gamma cycle —
``times[i] < t_steps`` — into a dense prefix of width ``n_active_max``,
keeping a line-index map so synaptic weights can be gathered to match.
Silent / out-of-window lines are pushed past the prefix and padded with
``NO_SPIKE``, which is inert in every engine. This is the software analogue
of the paper's unary top-k relocation.

Consumers: the ``event`` engine and the ``fused_compact`` kernel path of
:func:`repro_torch.core.neuron.fire_times_bank`. Shape-polymorphic over
leading batch axes, so one call compacts a whole ``(C, B, rf)`` gather.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import coding


def active_mask(times: torch.Tensor, t_steps: int) -> torch.Tensor:
    """Lines that can contribute a ramp bit within the gamma cycle
    (``times < t_steps``)."""
    return times < t_steps


def measured_density(times: torch.Tensor,
                     t_steps: Optional[int] = None) -> float:
    """Fraction of active lines as a Python float.

    With ``t_steps`` given, "active" means ``times < t_steps``; without
    it, simply non-``NO_SPIKE``.
    """
    if times.numel() == 0:
        return 0.0
    bound = t_steps if t_steps is not None else coding.NO_SPIKE
    return float((times < bound).to(torch.float32).mean())


def max_active(times: torch.Tensor, t_steps: int) -> int:
    """Max per-volley active-line count."""
    mask = active_mask(times, t_steps)
    if mask.numel() == 0:
        return 0
    return int(mask.sum(dim=-1, dtype=torch.int32).max())


def active_stats(times: torch.Tensor, t_steps: int) -> Tuple[float, int]:
    """``(density, max_active)`` from one activity mask."""
    if times.numel() == 0:
        return 0.0, 0
    mask = active_mask(times, t_steps)
    per_volley = mask.sum(dim=-1, dtype=torch.int32)
    return (float(mask.to(torch.float32).mean()), int(per_volley.max()))


#: Vector-lane width the compacted-shape ladder aligns to at/above one
#: lane (kept from the reference so both packages pick the same widths).
LANE_WIDTH = 128


def bucket_width(s: int, quantum: int = 8, lane: int = LANE_WIDTH) -> int:
    """Snap a measured width onto the bucket ladder.

    Below one lane the ladder is the power-of-two multiples of ``quantum``
    (8, 16, 32, 64, 128); at or above ``lane`` it switches to lane
    multiples (128, 256, 384, ...), so distinct widths stay few.
    """
    s = max(int(s), 1)
    if s > lane:
        return -(-s // lane) * lane
    width = quantum
    while width < s:
        width *= 2
    return min(width, lane)


@dataclasses.dataclass
class CompactVolleys:
    """Dense-prefix view of a volley batch.

    times:      (..., s) int32 — active lines first (original line order
                preserved), then ``NO_SPIKE`` padding.
    line_index: (..., s) int32 — original line id of each slot (padding
                slots point at inactive lines; their ``NO_SPIKE`` time keeps
                them inert regardless of the weight gathered).
    n_active:   (...,)  int32 — true active count per volley.
    overflow:   (...,)  int32 — active lines dropped because ``s`` was too
                small (always 0 when the width was measured, not forced).
    """

    times: torch.Tensor
    line_index: torch.Tensor
    n_active: torch.Tensor
    overflow: torch.Tensor

    @property
    def width(self) -> int:
        return self.times.shape[-1]


def compact_volleys(times: torch.Tensor, t_steps: int,
                    n_active_max: Optional[int] = None) -> CompactVolleys:
    """Gather each volley's active lines into a dense prefix.

    Args:
      times: (..., n) int32 spike times.
      t_steps: gamma-cycle length (defines "active").
      n_active_max: compacted width; ``None`` measures the exact max over
        the batch.

    Returns:
      :class:`CompactVolleys` of width ``min(n_active_max, n)``.
    """
    times = times.to(torch.int32)
    n = times.shape[-1]
    mask = active_mask(times, t_steps)
    n_act = mask.sum(dim=-1, dtype=torch.int32)
    if n_active_max is None:
        n_active_max = max(int(n_act.max()) if times.numel() else 0, 1)
    s = min(int(n_active_max), n) if n > 0 else 1
    # stable sort of the inactive flag: active line ids first, original
    # order preserved (the relocation permutation of paper Fig. 5)
    order = torch.argsort((~mask).to(torch.int32), dim=-1, stable=True)
    line_index = order[..., :s].to(torch.int32)
    times_c = torch.gather(times, -1, line_index.long())
    slot = torch.arange(s, dtype=torch.int32, device=times.device)
    times_c = torch.where(slot < n_act[..., None], times_c,
                          torch.full_like(times_c, coding.NO_SPIKE))
    overflow = torch.clamp(n_act - s, min=0)
    return CompactVolleys(times=times_c, line_index=line_index,
                          n_active=n_act, overflow=overflow)


def gather_weights(weights: torch.Tensor,
                   line_index: torch.Tensor) -> torch.Tensor:
    """Per-volley weight gather matching a compaction's line-index map.

    Args:
      weights:    (..., Q, n) synaptic weights.
      line_index: (..., B, s) from :func:`compact_volleys`.

    Returns:
      (..., B, Q, s): ``out[..., b, q, j] = weights[..., q, index[b, j]]``.
    """
    lead = line_index.shape[:-2]
    b, s = line_index.shape[-2:]
    q = weights.shape[-2]
    w = weights[..., None, :, :].expand(*lead, b, q, weights.shape[-1])
    idx = line_index[..., :, None, :].expand(*lead, b, q, s).long()
    return torch.gather(w, -1, idx)
