"""Cost-driven engine policy: the single engine-selection entry point.

An :class:`EnginePolicy` predicts the runtime of each candidate engine from
an analytic work model and picks the cheapest — for both the engine and the
compaction bucket width.

Work model (per volley x neuron pair, int32 ops):

  * dense engines (``closed_form``, ``scan``, ``fused``) touch every tick of
    every line: ``t = c_engine * pairs * T * n``.
  * sparse engines (``event``, ``fused_compact``) sort the ``m = 2*s`` ramp
    breakpoints of the ``s`` compacted lines:
    ``t = pairs * (a_event + b_event * m)``.

The coefficients are the reference package's committed fit, unchanged;
:func:`fit_coefficients` refits the event and closed-form ones from a
sparsity sweep's rows, as the reference's does. They were fit to CPU
runs, so they rank the CPU engines only; on a CUDA device ``auto`` does
not consult them: the fused kernel preempts.

Resolution: explicit backend names pass through; on a CUDA device ``auto``
resolves to ``fused`` (decided by the tensors' device, never by probing
whether the kernel builds — a build failure raises where the kernel is
launched); elsewhere ``auto`` is the cost model's pick at the measured
workload, and an unknown workload keeps the dense choice.

Under a ``("data", "column")`` mesh (:mod:`repro_torch.sharding.specs`,
passed as ``mesh=``) the fused engines run through the sharded wrappers
(:mod:`repro_torch.kernels.rnl_shard`) where every column count tiles the
mesh's ``column`` axis. Where one does not, every rank holds the whole
column stack: on a CUDA device the kernel then runs unsharded on that
replicated block, and ``auto`` stays ``fused``; on the CPU the fused
engines degrade to the engine of the same sparsity class (``fused`` to
``closed_form``, ``fused_compact`` to ``event``), as the reference's do
wherever ``shard_map`` cannot tile the columns.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Iterable, Literal, NamedTuple, Optional, Union

import torch

from repro_torch.core import compaction
from repro_torch.sharding import specs as sharding_specs

Backend = Literal["auto", "scan", "closed_form", "event", "fused",
                  "fused_compact"]

#: Legacy ``auto`` threshold (the ``mode="density"`` escape hatch): a
#: measured input density at or below this picks the event engine.
DENSITY_EVENT_MAX = 0.25

#: Engines that evaluate over spike-compacted volleys and therefore take a
#: compaction width (``n_active_max``).
SPARSE_ENGINES = ("event", "fused_compact")

DeviceLike = Union[str, torch.device, None]

ColumnCounts = Union[int, Iterable[int], None]


def mesh_active(mesh) -> bool:
    """Whether ``mesh`` is a device mesh with named axes (``None``: the
    single-device path)."""
    return bool(sharding_specs.axis_names(mesh))


def _fused_shardable(n_columns: Optional[int], mesh) -> bool:
    """Mesh capability of the fused engines.

    True without a mesh (a plain single-device launch). Under a mesh the
    sharded wrappers need a 3-D column stack whose column count tiles the
    ``column`` axis: ``n_columns is None`` (a 2-D ``(B, n)`` bank) and a
    mesh without a ``column`` axis give False.
    """
    if not mesh_active(mesh):
        return True
    if n_columns is None:
        return False
    if sharding_specs.TNN_COLUMN_AXIS not in sharding_specs.axis_names(mesh):
        return False
    return n_columns % sharding_specs.tnn_column_size(mesh) == 0


def _effective_engine(engine: str, column_counts: ColumnCounts = None,
                      mesh=None, device: DeviceLike = None) -> str:
    """The engine that will run for ``engine`` on ``mesh``. The fused
    engines pass through on a CUDA device (the sharded wrappers, or the
    kernel on a replicated stack), and elsewhere when every count in
    ``column_counts`` (one count, or one per layer) is
    :func:`_fused_shardable`; otherwise — replication fallback, a 2-D
    bank, or an unknown shape (``None``) — they degrade to the engine of
    the same sparsity class. Everything else, and everything without a
    mesh, passes through."""
    if engine not in ("fused", "fused_compact") or not mesh_active(mesh) \
            or _on_cuda(device):
        return engine
    if column_counts is not None:
        counts = ((column_counts,) if isinstance(column_counts, int)
                  else tuple(column_counts))
        if counts and all(_fused_shardable(c, mesh) for c in counts):
            return engine
    return "event" if engine == "fused_compact" else "closed_form"


class BankShape(NamedTuple):
    """Workload of one neuron-bank evaluation, as the predictor sees it.

    pairs:   volley x neuron evaluations (B*Q, summed over columns).
    n_lines: dendritic input lines per neuron (n; the receptive field).
    t_steps: gamma-cycle length in ticks (T).
    """

    pairs: int
    n_lines: int
    t_steps: int


class Resolution(NamedTuple):
    """What :meth:`EnginePolicy.resolve` decided, and why.

    engine:       the engine that will run (after the mesh degradation).
    requested:    the explicit backend name, or the policy's pick for
                  ``auto``, before the mesh degradation.
    width:        compaction bucket width for the sparse engines (None
                  when the active-line count is unknown).
    predicted_us: per-candidate predicted runtime for the decision taken
                  ({} when no prediction was needed).
    """

    engine: str
    requested: str
    width: Optional[int]
    predicted_us: Dict[str, float]


@dataclasses.dataclass(frozen=True)
class CostCoefficients:
    """Calibrated work-model coefficients (the reference's committed fit,
    taken on a CPU host; ``fused_unit_us`` is a prior, not a fit)."""

    #: us per pair*tick*line, dense closed form.
    closed_form_unit_us: float = 5.34e-3
    #: us per pair*tick*line, tick-scan hardware mirror.
    scan_unit_us: float = 7.74e-3
    #: us per pair, fixed event-engine overhead.
    event_pair_us: float = 0.093
    #: us per pair*breakpoint; the sorted width is m = 2*s.
    event_breakpoint_us: float = 0.192
    #: us per pair*tick*line, fused sweep (prior, not a fit).
    fused_unit_us: float = 6.7e-4

    def predict_us(self, engine: str, shape: BankShape,
                   width: Optional[int] = None) -> float:
        """Predicted wall-clock (us) for one bank evaluation.

        ``width`` is the compacted width for the sparse engines; ``None``
        means uncompacted (sort all ``2 * n_lines`` breakpoints).
        """
        dense_units = shape.pairs * shape.t_steps * shape.n_lines
        if engine == "closed_form":
            return self.closed_form_unit_us * dense_units
        if engine == "scan":
            return self.scan_unit_us * dense_units
        if engine == "fused":
            return self.fused_unit_us * dense_units
        if engine in SPARSE_ENGINES:
            s = shape.n_lines if width is None else min(width, shape.n_lines)
            m = 2 * max(int(s), 1)
            return shape.pairs * (self.event_pair_us
                                  + self.event_breakpoint_us * m)
        raise ValueError(f"unknown engine {engine!r}")


def fit_coefficients(rows: Iterable[dict], *, pairs: int, n_lines: int,
                     t_steps: int,
                     base: Optional[CostCoefficients] = None
                     ) -> CostCoefficients:
    """Re-derive the event and closed-form coefficients from sparsity-sweep
    rows (dicts with ``backend``, ``density`` and ``us_per_call``, as the
    reference's ``BENCH_sparsity`` ``results`` list holds them).

    The sweep places exactly ``round(density * n)`` spiking lines per
    volley, so each event row's compacted bucket width, and hence its
    sorted breakpoint count ``m``, is known: compacted rows use ``2 *
    bucket_width(s)``, uncompacted (``event_nc``) rows ``2 * n``.
    ``closed_form`` takes the median row; the event model is the
    least-squares affine fit in ``pairs * m``. The other coefficients
    carry over from ``base``. Raises ``ValueError`` without a closed-form
    row and two event rows."""
    closed, event_pts = [], []
    for row in rows:
        us = row.get("us_per_call")
        backend = row.get("backend")
        density = row.get("density")
        if not isinstance(us, (int, float)) or density is None:
            continue
        if backend == "closed_form":
            closed.append(float(us))
        elif backend in ("event", "event_nc"):
            s = max(int(round(float(density) * n_lines)), 1)
            w = n_lines if backend == "event_nc" \
                else min(compaction.bucket_width(s), n_lines)
            event_pts.append((pairs * 2 * w, float(us)))
    if not closed or len(event_pts) < 2:
        raise ValueError("need closed_form rows and >=2 event rows to fit")
    closed.sort()
    mid = len(closed) // 2
    median = (closed[mid] if len(closed) % 2
              else 0.5 * (closed[mid - 1] + closed[mid]))
    c_cf = median / (pairs * t_steps * n_lines)
    xbar = sum(x for x, _ in event_pts) / len(event_pts)
    ybar = sum(y for _, y in event_pts) / len(event_pts)
    sxx = sum((x - xbar) ** 2 for x, _ in event_pts)
    sxy = sum((x - xbar) * (y - ybar) for x, y in event_pts)
    slope = sxy / sxx
    intercept = max((ybar - slope * xbar) / pairs, 0.0)
    base = base if base is not None else CostCoefficients()
    return dataclasses.replace(base, closed_form_unit_us=c_cf,
                               event_pair_us=intercept,
                               event_breakpoint_us=slope)


def _on_cuda(device: DeviceLike) -> bool:
    return device is not None and torch.device(device).type == "cuda"


@dataclasses.dataclass(frozen=True)
class EnginePolicy:
    """Engine + compaction-width selection, in one host-side object.

    ``mode="cost"`` (default) ranks the candidates by
    :meth:`CostCoefficients.predict_us` at the measured workload;
    ``mode="density"`` reproduces the legacy ``DENSITY_EVENT_MAX``
    threshold. Both modes keep explicit names as given, let a CUDA device
    preempt ``auto`` with the fused kernel, degrade the fused engines last
    under a mesh on the CPU, and keep an unknown workload dense. Frozen
    (hashable) so it can ride on the frozen layer configs.
    """

    mode: str = "cost"
    coeffs: CostCoefficients = CostCoefficients()
    density_event_max: float = DENSITY_EVENT_MAX

    def __post_init__(self):
        if self.mode not in ("cost", "density"):
            raise ValueError(
                f"unknown policy mode {self.mode!r}: expected 'cost' or "
                f"'density'")

    def wants_density(self, backend: Backend,
                      device: DeviceLike = None) -> bool:
        """Whether :meth:`resolve` can use a measured density/active count
        for ``backend`` — False for explicit names and on a CUDA device,
        so callers skip the reduction and the host sync."""
        return backend == "auto" and not _on_cuda(device)

    def resolve(self, backend: Backend = "auto", *,
                density: Optional[float] = None,
                max_active: Optional[int] = None,
                column_counts: ColumnCounts = None,
                shape: Optional[BankShape] = None,
                device: DeviceLike = None, mesh=None) -> Resolution:
        """Resolve ``backend`` to the engine that should run on ``device``
        (the device of the tensors it will run on; ``None`` = not CUDA).

        Takes the measured workload (``density`` and/or ``max_active``),
        the column structure and ``mesh`` (for the mesh capability check)
        and the bank shape (for the predictor), and returns the
        :class:`Resolution` — engine, request, compaction width, and the
        predictions behind the choice.
        """
        predicted: Dict[str, float] = {}
        s_active = self._active_lines(density, max_active, shape)
        if backend != "auto":
            requested = backend
        elif _on_cuda(device):
            requested = "fused"
        elif self.mode == "density":
            requested = ("event" if density is not None
                         and density <= self.density_event_max
                         else "closed_form")
        elif s_active is None or shape is None:
            requested = "closed_form"
        else:
            width = self.width_for(s_active, shape)
            predicted = {
                "event": self.coeffs.predict_us("event", shape, width),
                "closed_form": self.coeffs.predict_us("closed_form", shape),
            }
            # dict order breaks exact ties toward the sparse engine
            requested = min(predicted, key=predicted.__getitem__)
        engine = _effective_engine(requested, column_counts, mesh, device)
        width = (self.width_for(s_active, shape)
                 if engine in SPARSE_ENGINES and s_active is not None
                 else None)
        return Resolution(engine=engine, requested=requested,
                          width=width, predicted_us=predicted)

    def width_for(self, max_active: int,
                  shape: Optional[BankShape] = None) -> int:
        """Cost-chosen compaction width covering ``max_active`` lines: the
        cheapest of the covering bucket-ladder rung and the next one."""
        s = max(int(max_active), 1)
        cover = compaction.bucket_width(s)
        if shape is None:
            return cover
        rungs = {cover, compaction.bucket_width(cover + 1)}
        return min(sorted(rungs),
                   key=lambda w: self.coeffs.predict_us("event", shape, w))

    def _active_lines(self, density: Optional[float],
                      max_active: Optional[int],
                      shape: Optional[BankShape]) -> Optional[int]:
        """Best available per-volley active-line count: the measured max
        when given, else a conservative (ceil) estimate from density."""
        if max_active is not None:
            return int(max_active)
        if density is not None and shape is not None:
            return min(int(math.ceil(density * shape.n_lines)),
                       shape.n_lines)
        return None


@functools.lru_cache(maxsize=None)
def _policy_for_mode(mode: str) -> EnginePolicy:
    return EnginePolicy(mode=mode)


def default_policy() -> EnginePolicy:
    """The memoized cost-driven policy (committed coefficients)."""
    return _policy_for_mode("cost")


def density_policy() -> EnginePolicy:
    """The memoized legacy density-threshold policy (escape hatch)."""
    return _policy_for_mode("density")


def get_policy(spec: Union[str, EnginePolicy]) -> EnginePolicy:
    """Validate/normalize a policy spec: ``"cost"``, ``"density"``, or an
    :class:`EnginePolicy` instance."""
    if isinstance(spec, EnginePolicy):
        return spec
    if spec == "cost":
        return default_policy()
    if spec == "density":
        return density_policy()
    raise ValueError(
        f"unknown engine policy {spec!r}: expected 'cost', 'density', or "
        f"an EnginePolicy instance")
