"""Spike-timing-dependent plasticity configuration (Smith [12, 13]).

Only the configuration a :class:`repro_torch.core.layer.TNNLayer` carries
is here; the STDP rules come with the learning-while-serving slice.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class STDPConfig:
    w_max: int = 7
    mu_capture: float = 1.0
    mu_backoff: float = 0.5
    mu_search: float = 0.25
    #: stabilization: scale updates by 4*(w/wmax)*(1-w/wmax) + floor
    stabilize: bool = True
    stab_floor: float = 0.25
