"""Sharding rules of the TNN stack over a ``("data", "column")`` mesh.

The TNN scales by tiling RNL columns side by side: the (columns, neurons)
plane is sharded over a ``column`` mesh axis and the volley batch over
``data``:

  tensor                      shape         spec
  ------------------------    -----------   --------------------------
  layer weights               (C, Q, rf)    (column, None, None)
  post-gather volleys         (C, B, rf)    (column, data, None)
  bank fire times             (C, B, Q)     (column, data, None)
  post-WTA / winners          (B, C, ...)   (data, column, ...)
  input volley batch          (B, n_in)     (data, None)

Every rule runs through :func:`_fit`: a column count (or batch) that the
axis does not divide degrades that dim to replication.

The port is explicitly SPMD, as under ``torchrun``: every rank runs the
same host loop on the same requests and holds its own block of each
tensor. A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh`
(:func:`tnn_mesh`), always passed as an explicit ``mesh=`` argument —
there is no ambient mesh. A spec is a tuple with one entry per dim: an
axis name, a tuple of axis names, or ``None``. :func:`shard_of` cuts a
whole tensor to this rank's block under a resolved spec and
:func:`gather` puts the blocks back together
(``dist.all_gather_into_tensor``, the pieces ordered by mesh coordinate,
never by global rank; an axis of one rank needs none).

The rules read only a mesh's ``mesh_dim_names`` and ``shape``.
"""

from __future__ import annotations

import math
from typing import (Any, Callable, Dict, Hashable, Optional,
                    Sequence, Tuple, Union)

import torch
import torch.distributed as dist

from repro_torch.kernels.common import resolve_device

Axis = Union[str, Tuple[str, ...], None]
Spec = Tuple[Axis, ...]

#: mesh axis carrying the (columns, neurons) plane
TNN_COLUMN_AXIS = "column"


#: per mesh (by identity): the mesh and what has been read or derived
#: from it, keyed by :func:`memo`'s keys
_MEMO: Dict[int, Tuple[object, Dict[Hashable, Any]]] = {}
#: meshes remembered at most; the memo starts afresh past it
_MEMO_MESHES = 64


def memo(mesh, key: Hashable, make: Callable[[], Any]) -> Any:
    """``make()`` for ``mesh`` under ``key``, computed once a mesh. A
    mesh's layout does not change, and reading it through ``DeviceMesh``'s
    accessors costs host time on every call, so the rules, the blocks and
    the checks read a mesh once and reuse what they derived."""
    hit = _MEMO.get(id(mesh))
    if hit is None or hit[0] is not mesh:
        if len(_MEMO) >= _MEMO_MESHES:
            _MEMO.clear()
        hit = _MEMO[id(mesh)] = (mesh, {})
    table = hit[1]
    if key not in table:
        table[key] = make()
    return table[key]


def axis_names(mesh) -> Tuple[str, ...]:
    if mesh is None:
        return ()
    return memo(mesh, "names", lambda: tuple(mesh.mesh_dim_names or ()))


def _sizes(mesh) -> Dict[str, int]:
    if mesh is None:
        return {}
    return memo(mesh, "sizes", lambda: dict(zip(
        axis_names(mesh), (int(s) for s in mesh.shape))))


def axis_size(mesh, axis: Axis) -> int:
    if axis is None:
        return 1
    sizes = _sizes(mesh)
    if isinstance(axis, str):
        return sizes[axis]
    return math.prod(sizes[a] for a in axis)


def _fit(mesh, dim: int, axis: Axis) -> Axis:
    """Use ``axis`` if it divides ``dim``, else try prefixes, else None."""
    if axis is None:
        return None
    if isinstance(axis, str):
        return axis if dim % axis_size(mesh, axis) == 0 else None
    for cut in range(len(axis), 0, -1):
        cand = axis[:cut] if cut > 1 else axis[0]
        if dim % axis_size(mesh, cand) == 0:
            return cand
    return None


def dp_spec_names() -> tuple:
    """The DP axis group for in-model constraints."""
    return ("pod", "data")


def dp_axes(mesh) -> Tuple[str, ...]:
    names = axis_names(mesh)
    return tuple(a for a in dp_spec_names() if a in names)


def batch_pspec(mesh, batch: int, extra_dims: int = 1,
                over_model: bool = False) -> Spec:
    """Shard the leading batch dim over as much DP as divides it;
    ``over_model`` additionally folds the model axis into DP."""
    axes = dp_axes(mesh) + (("model",) if over_model else ())
    return (_fit(mesh, batch, axes),) + (None,) * extra_dims


def ambient_fit(dim: int, entry: Axis, mesh=None) -> Axis:
    """Resolve one axis entry against ``mesh``: the subset of ``entry``'s
    axes the mesh has, when their combined size divides ``dim`` — else
    None (replication). The one per-dim rule of :func:`maybe_wsc` and of
    the sharded RNL wrappers (:mod:`repro_torch.kernels.rnl_shard`)."""
    names = axis_names(mesh)
    if not names or entry is None:
        return None
    entry_t = entry if isinstance(entry, tuple) else (entry,)
    avail = tuple(a for a in entry_t if a in names)
    if not avail:
        return None
    if dim % axis_size(mesh, avail):
        return None
    return avail if len(avail) > 1 else avail[0]


def maybe_wsc(x: torch.Tensor, *spec: Axis, mesh=None,
              shape: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Check that ``x`` is this rank's block of a whole tensor of
    ``shape`` laid out under ``spec``; identity without a mesh.

    ``spec`` entries are axis names, tuples of axis names, or None; an
    entry whose axes do not divide its dim means replication there
    (:func:`ambient_fit`). Raises ``ValueError`` when the block has another
    shape than the rule implies. Returns ``x``."""
    if not axis_names(mesh):
        return x
    if shape is None:
        raise ValueError("maybe_wsc under a mesh needs the whole tensor's "
                         "shape")
    shape = tuple(int(d) for d in shape)
    want = memo(mesh, ("block", spec, shape), lambda: tuple(
        d // axis_size(mesh, ambient_fit(d, e, mesh))
        for d, e in zip(shape, spec)) + shape[len(spec):])
    if tuple(x.shape) != want:
        raise ValueError(
            f"block {tuple(x.shape)} is not this rank's block of "
            f"{shape} under {spec} on mesh {dict(_sizes(mesh))}: expected "
            f"{want}")
    return x


# ------------------------------------------------------------ TNN rules

def tnn_column_size(mesh=None) -> int:
    """Size of the mesh's ``column`` axis (1 without a mesh or such an
    axis): the divisor a column count must divide for the sharded RNL
    wrappers to tile it."""
    return _sizes(mesh).get(TNN_COLUMN_AXIS, 1)


def tnn_mesh(n_column: Optional[int] = None, n_data: int = 1, *,
             devices: Optional[Sequence[int]] = None,
             device_type: str = "cuda"):
    """DeviceMesh with ``("data", "column")`` dims over the world's ranks.

    ``devices`` are global ranks (default: every rank of the initialised
    process group); ``n_column`` defaults to all of them not consumed by
    ``n_data``, and the mesh takes the first ``n_data * n_column``. A 1x1
    mesh is valid and makes every rule shard over axes of size 1. A
    ``cuda`` mesh (the default) needs the NCCL backend and a ``cpu`` mesh
    gloo: nothing falls back to another backend or device.
    """
    if devices is None:
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("tnn_mesh needs an initialised process "
                               "group (torch.distributed.init_process_group)")
        devices = range(dist.get_world_size())
    devices = list(devices)
    if n_data <= 0:
        raise ValueError(f"n_data must be positive, got {n_data}")
    if n_column is None:
        if len(devices) % n_data:
            raise ValueError(
                f"n_data={n_data} does not divide {len(devices)} devices")
        n_column = len(devices) // n_data
    if n_column <= 0:
        raise ValueError(f"n_column must be positive, got {n_column}")
    need = n_data * n_column
    if need > len(devices):
        raise ValueError(f"mesh ({n_data}, {n_column}) needs {need} "
                         f"devices, have {len(devices)}")
    backend = str(dist.get_backend())
    if device_type == "cuda":
        resolve_device("cuda")
        if "nccl" not in backend:
            raise ValueError(f"a cuda mesh needs the nccl backend, the "
                             f"process group has {backend!r}")
    elif device_type == "cpu":
        if "gloo" not in backend:
            raise ValueError(f"a cpu mesh needs the gloo backend, the "
                             f"process group has {backend!r}")
    else:
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got "
                         f"{device_type!r}")
    from torch.distributed.device_mesh import DeviceMesh
    ranks = torch.tensor(devices[:need], dtype=torch.int64)
    return DeviceMesh(device_type, ranks.reshape(n_data, n_column),
                      mesh_dim_names=("data", TNN_COLUMN_AXIS))


def tnn_param_pspec(mesh, n_columns: int) -> Spec:
    """Layer weights (C, Q, rf): columns over ``column``, else replicate."""
    return (_fit(mesh, n_columns, TNN_COLUMN_AXIS), None, None)


def tnn_param_axes() -> tuple:
    """:func:`maybe_wsc` axis entries for a (C, Q, rf) weight stack — the
    check's twin of :func:`tnn_param_pspec`; ``layer_step`` checks its new
    weights with it, so they keep the input stack's placement."""
    return (TNN_COLUMN_AXIS, None, None)


def tnn_volley_axes() -> tuple:
    """:func:`maybe_wsc` axis entries for column-stacked volley tensors
    ``(C, B, ...)``; :func:`tnn_data_pspec` derives from it."""
    return (TNN_COLUMN_AXIS, dp_spec_names(), None)


def tnn_data_pspec(mesh, n_columns: int, batch: int) -> Spec:
    """Post-gather volley tensor (C, B, rf): columns over ``column``,
    batch over the DP group; either dim degrades independently."""
    col, _, _ = tnn_volley_axes()
    return (_fit(mesh, n_columns, col), _fit(mesh, batch, dp_axes(mesh)),
            None)


def tnn_batch_pspec(mesh, batch: int) -> Spec:
    """Input volley batch (B, n_inputs): batch over the DP group."""
    return batch_pspec(mesh, batch, extra_dims=1)


def tnn_stage_axes() -> tuple:
    """:func:`maybe_wsc` axis entries for a pipeline stage buffer ``(mb,
    n_lines)``: the micro-batch over the DP group and the flattened
    ``C_l * Q_l`` output lines over ``column``."""
    return (dp_spec_names(), TNN_COLUMN_AXIS)


def tnn_stage_pspec(mesh, batch: int, n_lines: int) -> Spec:
    """Placement of a pipeline stage buffer ``(mb, n_lines)``, the
    externally-placed twin of :func:`tnn_stage_axes`."""
    dp, col = tnn_stage_axes()
    return (_fit(mesh, batch, dp_axes(mesh)), _fit(mesh, n_lines, col))


def tnn_carry_axes() -> tuple:
    """:func:`maybe_wsc` axis entries for a recurrent carry ``(B,
    n_outputs)``: the stage buffer's rule, since a carry is last cycle's
    output volley."""
    return tnn_stage_axes()


def tnn_carry_pspec(mesh, batch: int, n_outputs: int) -> Spec:
    """Placement of a recurrent carry ``(B, n_outputs)``, the
    externally-placed twin of :func:`tnn_carry_axes`.

    The port's layers keep a carry with all of its layer's lines on every
    column rank (the next cycle's receptive fields may read any of them),
    so only its batch dim follows this rule there."""
    return tnn_stage_pspec(mesh, batch, n_outputs)


# ------------------------------------------------------ blocks of a rank

def mesh_device(mesh, device=None) -> torch.device:
    """The device a mesh's blocks live on: the current CUDA device for a
    ``cuda`` mesh, the CPU for a ``cpu`` one. Raises ``ValueError`` when
    ``device`` is given and is another device."""
    if mesh.device_type == "cuda":
        resolve_device("cuda")
        own = torch.device("cuda", torch.cuda.current_device())
    else:
        own = torch.device(mesh.device_type)
    if device is not None:
        dev = torch.device(device)
        if dev.type != own.type or (dev.index is not None
                                    and dev.index != own.index):
            raise ValueError(f"device {dev} disagrees with the mesh's "
                             f"device {own}")
    return own


def _coords(mesh) -> Dict[str, int]:
    def read():
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank is not in the mesh")
        return dict(zip(axis_names(mesh), (int(c) for c in coord)))
    return memo(mesh, "coords", read)


def is_origin(mesh) -> bool:
    """Whether this rank sits at coordinate 0 on every mesh dim."""
    return not any(_coords(mesh).values())


def _axes(entry: Axis) -> Tuple[str, ...]:
    return (entry,) if isinstance(entry, str) else tuple(entry)


def split(mesh, entry: Axis) -> Axis:
    """``entry`` where it spreads a dim over more than one rank, else
    None: over axes of one rank in all, every rank's block is whole, as
    under replication, and needs no collective."""
    if entry is None or axis_size(mesh, entry) == 1:
        return None
    return entry


def block_slice(mesh, dim: int, entry: Axis) -> slice:
    """This rank's slice of a dim of size ``dim`` under a resolved entry:
    its block index is its coordinate over ``entry``'s axes, row-major."""
    if entry is None:
        return slice(0, dim)
    return memo(mesh, ("slice", dim, entry),
                lambda: _block_slice(mesh, dim, entry))


def _block_slice(mesh, dim: int, entry: Axis) -> slice:
    n = axis_size(mesh, entry)
    if dim % n:
        raise ValueError(f"dim {dim} does not split over {entry!r} "
                         f"(size {n})")
    sizes, coords = _sizes(mesh), _coords(mesh)
    index = 0
    for a in _axes(entry):
        index = index * sizes[a] + coords[a]
    step = dim // n
    return slice(index * step, (index + 1) * step)


def shard_of(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of the whole tensor ``x`` under the resolved
    ``spec`` (a copy, so the block does not keep ``x`` alive); ``x``
    itself without a mesh."""
    if mesh is None:
        return x
    idx = tuple(block_slice(mesh, d, e) for d, e in zip(x.shape, spec))
    return x[idx].clone()


def _gather_plan(mesh, axis: str):
    """This rank's group along ``axis``, its size, and the order that puts
    the group's all-gather pieces (which come in the group's rank order)
    in the order of their coordinate on ``axis`` (``None`` where the two
    orders agree)."""
    group = mesh.get_group(axis)
    members = dist.get_process_group_ranks(group)
    d = axis_names(mesh).index(axis)
    coord = list(mesh.get_coordinate())
    order = []
    for i in range(int(mesh.shape[d])):
        coord[d] = i
        order.append(members.index(int(mesh.mesh[tuple(coord)])))
    return group, len(members), (None if order == sorted(order)
                                 else order)


def _all_gather(x: torch.Tensor, dim: int, axis: str, mesh) -> torch.Tensor:
    """``x``'s pieces from every rank of this rank's ``axis`` group,
    concatenated along ``dim`` in coordinate order: one
    ``all_gather_into_tensor`` (gloo and NCCL both take it) into a
    buffer of the pieces stacked along dim 0."""
    group, n, order = memo(mesh, ("gather", axis),
                           lambda: _gather_plan(mesh, axis))
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    pieces = out.view((n,) + tuple(x.shape))
    if order is not None:
        pieces = pieces[order]
    if dim == 0 and order is None:
        return out
    shape = list(x.shape)
    shape[dim] *= n
    return pieces.movedim(0, dim).reshape(shape)


def gather(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The whole tensor from this rank's block ``x`` under the resolved
    ``spec``: one all-gather per sharded axis of more than one rank, on
    every rank of its group (over an axis of one rank the block is
    already whole along it). The inverse of :func:`shard_of`; ``x``
    without a mesh."""
    if mesh is None:
        return x
    sizes = _sizes(mesh)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for a in reversed(_axes(entry)):
            if sizes[a] > 1:
                x = _all_gather(x, dim, a, mesh)
    return x


def barrier(mesh) -> None:
    """Wait on the host until every rank of ``mesh`` has reached this
    point: a one-element all-reduce over each mesh dim in turn."""
    t = torch.zeros(1, device=mesh_device(mesh))
    for a in axis_names(mesh):
        dist.all_reduce(t, group=mesh.get_group(a))
    t.item()
