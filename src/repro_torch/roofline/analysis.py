"""Roofline terms of one (architecture x shape x mesh) cell, per rank:

  compute term    = FLOPs_per_rank / PEAK_FLOPS
  memory term     = bytes_per_rank / HBM_BW
  collective term = collective_bytes_per_rank / LINK_BW

The per-rank quantities come from one rank's step, counted by
:mod:`repro_torch.roofline.op_cost` (the dry run traces it on a fake
rank, :mod:`repro_torch.launch.dryrun`). The formulas are the reference's
(``src/repro/roofline/analysis.py``); the constants are the card's:
NVIDIA H100 80GB HBM3 (SXM) at its 700 W limit, from NVIDIA's data sheet.
Collective bytes are the output buffers of the step's all-gathers,
all-reduces, reduce-scatters and all-to-alls, a traffic proxy (a ring
all-reduce moves about twice that).
"""

from __future__ import annotations

import dataclasses

#: NVIDIA H100 80GB HBM3, 700 W: dense bf16 tensor-core FLOP/s (data
#: sheet, without sparsity)
PEAK_FLOPS = 989e12
#: NVIDIA H100 80GB HBM3, 700 W: HBM3 bytes/s (data sheet)
HBM_BW = 3.35e12
#: NVIDIA H100 80GB HBM3, 700 W: bytes/s a GPU sends to another node, one
#: 400 Gb/s NIC per GPU of an 8-GPU node (DGX H100 reference design);
#: every production mesh axis (16 ranks) crosses nodes
LINK_BW = 50e9


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    model_flops: float            # 6*N*D (train) or 2*N*D (inference)
    useful_flops_ratio: float     # model_flops / (flops_per_chip * chips)
    #: ideal_time / step_time_bound: the fraction of the compute roofline
    #: this cell reaches if the dominant term were the only limit
    roofline_fraction: float = 0.0

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Lower-bound step time: the largest term (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)


def compute_terms(*, flops_per_chip: float, bytes_per_chip: float,
                  coll_bytes_per_chip: float, chips: int,
                  model_flops_global: float) -> RooflineTerms:
    compute_s = flops_per_chip / PEAK_FLOPS
    memory_s = bytes_per_chip / HBM_BW
    collective_s = coll_bytes_per_chip / LINK_BW
    hlo_global = flops_per_chip * chips
    useful = model_flops_global / hlo_global if hlo_global else 0.0
    t = RooflineTerms(compute_s, memory_s, collective_s, flops_per_chip,
                      bytes_per_chip, coll_bytes_per_chip,
                      model_flops_global, useful)
    ideal_s = model_flops_global / (chips * PEAK_FLOPS)
    t.roofline_fraction = ideal_s / t.step_time_s if t.step_time_s else 0.0
    return t


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6*N_active*D for training, 2*N_active*D for one
    forward (prefill); decode processes global_batch tokens per step."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch     # one new token per sequence
