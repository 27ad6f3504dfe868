"""The RNL kernels over a ``("data", "column")`` mesh: one launch per
rank, on that rank's tile of the column stack.

Replaces ``src/repro/kernels/rnl_shard.py`` (``rnl_fire_times_layer_sharded``
:63, ``rnl_fire_times_compact_sharded`` :92), which wraps the Pallas kernels
in ``shard_map`` over the ``column`` (and data) axes. Those have no kernel
body of their own, and neither do these: each rank launches the existing
:mod:`repro_torch.kernels.rnl_neuron` kernel (``csrc/rnl_neuron.cu``) on
its own ``(C_local, B_local, ...)`` block. Columns are independent by
construction, so no rank needs another's data, and each launch's sweep
bound tightens to its own tile's last breakpoint.

One signature difference from the reference: the reference takes and
returns global arrays that ``shard_map`` cuts; here every rank passes its
block and gets its block back, with ``shape=`` naming the whole stack the
block belongs to (``mesh=`` and ``shape=`` are keywords; the block is the
whole stack when ``shape`` is omitted). The preconditions are the
reference's, and raise the same ``ValueError``s (:func:`_mesh_specs`): a
mesh, with a ``column`` axis, that the column count tiles. The batch dim
follows ``specs.ambient_fit``: sharded over the DP group when the axis
divides it, whole on every rank otherwise.

CPU blocks run the plain versions (``*_plain``, over
``rnl_neuron.rnl_fire_times_*_plain``); CUDA blocks launch the kernel or
raise. Each launch adds one to :data:`LAUNCHES` under the wrapper's name
(the inner kernel's own count in ``rnl_neuron.LAUNCHES`` moves too).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from repro_torch.kernels import rnl_neuron
from repro_torch.sharding import specs

#: kernel launches per wrapper name since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"rnl_fire_times_layer_sharded": 0,
                            "rnl_fire_times_compact_sharded": 0}


def reset_launches() -> None:
    """Set every launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _mesh_specs(n_columns: int, batch: int, mesh):
    """(column-axis entry, batch-axis entry) of a column-stacked launch,
    or raise if the sharded path cannot serve this shape."""
    names = specs.axis_names(mesh)
    if not names:
        raise ValueError(
            "no mesh — call the plain kernels in rnl_neuron")
    col = specs.TNN_COLUMN_AXIS
    if col not in names:
        raise ValueError(
            f"mesh {names} has no {col!r} axis; the TNN fast path shards "
            "columns (sharding.specs.tnn_mesh)")
    size = specs.axis_size(mesh, col)
    if n_columns % size:
        raise ValueError(
            f"{n_columns} columns do not divide the {col!r} axis (size "
            f"{size}); use the replication fallback (policy.resolve "
            "gates dispatch)")
    dp = specs.ambient_fit(batch, specs.dp_spec_names(), mesh)
    return col, dp


def _check_blocks(times: torch.Tensor, weights: torch.Tensor, mesh,
                  shape: Optional[Sequence[int]]) -> None:
    """Raise unless ``times``/``weights`` are this rank's blocks of a whole
    ``(C, B, ...)`` stack of ``shape`` (the block's own shape if None)."""
    whole = tuple(times.shape) if shape is None else tuple(shape)
    if len(whole) != times.dim():
        raise ValueError(f"shape {whole} for a {times.dim()}-D block")
    col, dp = _mesh_specs(whole[0], whole[1], mesh)
    specs.maybe_wsc(times, col, dp, *(None,) * (times.dim() - 2), mesh=mesh,
                    shape=whole)
    w_whole = (whole[0],) + tuple(weights.shape[1:])
    if weights.dim() == 4:              # per-volley compact weights
        w_whole = (whole[0], whole[1]) + tuple(weights.shape[2:])
    specs.maybe_wsc(weights, col, dp if weights.dim() == 4 else None,
                    *(None,) * (weights.dim() - 2), mesh=mesh,
                    shape=w_whole)


def rnl_fire_times_layer_sharded_plain(times, weights, *, t_steps,
                                       threshold, k=None, mesh=None,
                                       shape=None):
    """Plain PyTorch version of :func:`rnl_fire_times_layer_sharded`."""
    _check_blocks(times, weights, mesh, shape)
    return rnl_neuron.rnl_fire_times_layer_plain(
        times, weights, t_steps=t_steps, threshold=threshold, k=k)


def rnl_fire_times_layer_sharded(times: torch.Tensor, weights: torch.Tensor,
                                 *, t_steps: int, threshold: int,
                                 k: Optional[int] = None, mesh=None,
                                 shape: Optional[Sequence[int]] = None
                                 ) -> torch.Tensor:
    """:func:`repro_torch.kernels.rnl_neuron.rnl_fire_times_layer` on this
    rank's tile of a column stack.

    Args:
      times:   (C_local, B_local, n) int32, this rank's block of a whole
        ``(C, B, n)`` stack laid out per ``specs.tnn_volley_axes`` (columns
        over ``column``, batch over the DP group where it divides).
      weights: (C_local, Q, n) int32, this rank's columns.
      mesh: the ``("data", "column")`` mesh (``specs.tnn_mesh``).
      shape: the whole stack's ``(C, B, n)``.

    Returns:
      (C_local, B_local, Q) int32 fire times: this rank's block of the
      whole stack's fire times, bit-exact with the unsharded kernel
      (shards hold whole columns and whole volleys).
    """
    _check_blocks(times, weights, mesh, shape)
    kw = dict(t_steps=t_steps, threshold=threshold, k=k)
    if times.device.type == "cpu":
        return rnl_neuron.rnl_fire_times_layer_plain(times, weights, **kw)
    fire = rnl_neuron.rnl_fire_times_layer(times, weights, **kw)
    if fire.numel():
        LAUNCHES["rnl_fire_times_layer_sharded"] += 1
    return fire


def _fold(times: torch.Tensor, weights: torch.Tensor):
    """Fold the local columns into the batch: ``(c*b, s)``, ``(c*b, q, s)``."""
    c_l, b_l, s = times.shape
    return (times.reshape(c_l * b_l, s),
            weights.reshape(c_l * b_l, weights.shape[2], s))


def rnl_fire_times_compact_sharded_plain(times, weights, *, t_steps,
                                         threshold, k=None, mesh=None,
                                         shape=None):
    """Plain PyTorch version of :func:`rnl_fire_times_compact_sharded`."""
    _check_blocks(times, weights, mesh, shape)
    fire = rnl_neuron.rnl_fire_times_compact_plain(
        *_fold(times, weights), t_steps=t_steps, threshold=threshold, k=k)
    return fire.reshape(times.shape[:2] + weights.shape[2:3])


def rnl_fire_times_compact_sharded(times: torch.Tensor,
                                   weights: torch.Tensor, *, t_steps: int,
                                   threshold: int, k: Optional[int] = None,
                                   mesh=None,
                                   shape: Optional[Sequence[int]] = None
                                   ) -> torch.Tensor:
    """Spike-compacted tile: the rank's local columns folded into its
    batch and one :func:`repro_torch.kernels.rnl_neuron.rnl_fire_times_compact`
    launch for all of them.

    Compaction itself (:mod:`repro_torch.core.compaction`) runs upstream on
    the block: its ops are row-local along the line axis.

    Args:
      times:   (C_local, B_local, s) int32 compacted spike times, this
        rank's block of a whole ``(C, B, s)`` stack of ``shape``.
      weights: (C_local, B_local, Q, s) int32 per-volley gathered weights.

    Returns:
      (C_local, B_local, Q) int32 fire times.
    """
    _check_blocks(times, weights, mesh, shape)
    kw = dict(t_steps=t_steps, threshold=threshold, k=k)
    if times.device.type == "cpu":
        fire = rnl_neuron.rnl_fire_times_compact_plain(
            *_fold(times, weights), **kw)
    else:
        ct, cw = _fold(times, weights)
        fire = rnl_neuron.rnl_fire_times_compact(ct.contiguous(),
                                                 cw.contiguous(), **kw)
        if fire.numel():
            LAUNCHES["rnl_fire_times_compact_sharded"] += 1
    return fire.reshape(times.shape[:2] + weights.shape[2:3])
