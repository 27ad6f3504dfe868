"""Sharding rules over a device mesh: the LM rules over ``("data",
"model")`` and the TNN rules over ``("data", "column")``.

The LM rules (:func:`param_pspec`, :func:`cache_pspec`,
:func:`batch_pspec`, :func:`data_shardings`) lay parameters, optimizer
state, serve caches and batches out as the reference's do: heads, d_ff,
vocab and d_inner over ``model``, MoE experts over ``model`` with their
d_ff over the DP axes, batches over the DP axes.

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

Every rule runs through :func:`_fit`: a dimension that the axis does not
divide degrades to replication.

The port is explicitly SPMD, as under ``torchrun``: every rank runs the
same host loop on the same requests and holds its own block of each
tensor. A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh`
(:func:`lm_mesh`, :func:`tnn_mesh`), always passed as an explicit
``mesh=`` argument — there is no ambient mesh. A spec is a tuple with one
entry per dim: an axis name, a tuple of axis names, or ``None``.
:func:`shard_of` cuts a whole tensor to this rank's block under a
resolved spec and :func:`gather` puts the blocks back together
(``dist.all_gather_into_tensor``, the pieces ordered by mesh coordinate,
never by global rank; an axis of one rank needs none);
:func:`shard_tree` and :func:`gather_tree` do so leaf by leaf for a
whole state. The collectives the LM mesh path differentiates through
(:func:`sum_over`, :func:`copy_to`, :func:`mean_over`,
:func:`count_once`, :func:`gather_along`, :func:`scatter_along`,
:func:`split_along`) are autograd functions with the backward each
needs.

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


# ------------------------------------------------------------- LM rules
# Axes: ``data`` (+ an outer ``pod``) is the data-parallel dimension;
# ``model`` carries tensor and expert parallelism:
#
#   * attention projections: heads over ``model``
#   * MLP in/out: d_ff over ``model``
#   * MoE experts: E over ``model`` and the expert d_ff over the DP axes
#   * embeddings: vocab over ``model`` (replicated with ``replicate_embed``)
#   * SSM in/out projections: d_inner over ``model``
#   * norms / biases / routers: replicated
#
# Every rule degrades to replication where the axis does not divide the
# dimension. Stacked-layer leaves (``layers`` / ``encoder``) get a leading
# ``None``. The rules key on leaf names: the reference's
# ``"params/layers/moe/w_gate"`` form, which :func:`_leaf_name` makes of
# the key strings the checkpoint walker gives a port tree.


def _leaf_name(key: str) -> str:
    """The reference's name of a leaf from its key under
    :func:`repro_torch.train.checkpoint._map_with_path` (``".params/layers/
    attn/wq"`` -> ``"params/layers/attn/wq"``): a NamedTuple field loses
    its dot, as ``GetAttrKey.name`` has none. The LM trees hold dicts and
    NamedTuples only; a sequence index would stay ``"0"`` where the
    reference writes ``"[0]"``, which no rule reads."""
    return "/".join(seg[1:] if seg.startswith(".") else seg
                    for seg in key.split("/"))


def _param_spec_base(name: str, shape: Tuple[int, ...], mesh,
                     replicate_embed: bool = False) -> Spec:
    """Spec of an unstacked parameter leaf named ``name``."""
    dp = dp_axes(mesh)
    last = name.rsplit("/", 1)[-1]

    def col(d_out_idx=-1):
        """Column-parallel: shard the output dim over model."""
        spec: list = [None] * len(shape)
        spec[d_out_idx] = _fit(mesh, shape[d_out_idx], "model")
        return tuple(spec)

    def row(d_in_idx=0):
        spec: list = [None] * len(shape)
        spec[d_in_idx] = _fit(mesh, shape[d_in_idx], "model")
        return tuple(spec)

    if last == "embed":
        if replicate_embed:
            return (None, None)
        return (_fit(mesh, shape[0], "model"), None)
    if last == "lm_head":
        return (None, None) if replicate_embed else col()
    # --- MoE expert stacks: (E, D, F) / (E, F, D)
    if "moe" in name and last in ("w_gate", "w_up") and len(shape) == 3:
        return (_fit(mesh, shape[0], "model"), None,
                _fit(mesh, shape[2], dp))
    if "moe" in name and last == "w_down" and len(shape) == 3:
        return (_fit(mesh, shape[0], "model"), _fit(mesh, shape[1], dp),
                None)
    if last == "router":
        return (None, None)
    # --- attention / MLP / SSM projections
    if last in ("wq", "wk", "wv", "w_ukv", "w_gate", "w_up", "in_proj"):
        return col()
    if last in ("wo", "w_down", "out_proj"):
        return row()
    # w_dkv, w_kr, patch_proj, frame_proj, conv_w, norms, dt_bias, a_log,
    # scalars
    return (None,) * len(shape)


#: the keys of the stacked-layer subtrees (their leaves lead with the layer
#: axis)
STACK_KEYS = ("layers", "encoder")


def param_pspec(key: str, leaf, mesh, replicate_embed: bool = False
                ) -> Spec:
    """Spec of the leaf at ``key`` (a checkpoint key string, see
    :func:`_leaf_name`) of whole shape ``leaf.shape``; optimizer-state
    prefixes share the parameter's layout (``params/...``, ``opt/m/...``,
    ``opt/v/...`` and ``ef/error/...`` name the same last segments)."""
    name = _leaf_name(key)
    shape = tuple(int(d) for d in leaf.shape)
    if any(s in STACK_KEYS for s in name.split("/")[:-1]):
        return (None,) + _param_spec_base(name, shape[1:], mesh,
                                          replicate_embed)
    return _param_spec_base(name, shape, mesh, replicate_embed)


def param_pspecs(tree, mesh, replicate_embed: bool = False):
    """Spec tree of a whole (or ``meta``) tree: params, a ``TrainState`` or
    any tree whose leaves are named as parameters; ``None`` subtrees stay
    ``None``. It stands for the reference's ``param_shardings`` too (a
    tree of ``NamedSharding``; a ``DeviceMesh`` and a spec say the same),
    which :func:`shard_tree` and :func:`gather_tree` apply leaf by leaf."""
    from repro_torch.train.checkpoint import _map_with_path
    return _map_with_path(tree, lambda key, leaf: param_pspec(
        key, leaf, mesh, replicate_embed))


def data_shardings(mesh, batch_shapes, over_model: bool = False
                   ) -> Dict[str, Spec]:
    """Spec of each batch entry (name -> anything with ``.shape``): the
    leading batch dim over the DP axes (:func:`batch_pspec`)."""
    return {k: batch_pspec(mesh, v.shape[0], len(v.shape) - 1, over_model)
            for k, v in batch_shapes.items()}


def cache_pspec(key: str, leaf, mesh) -> Spec:
    """Serve-state spec: batch over DP; KV heads over model when they
    divide; SSD state heads over model."""
    name = _leaf_name(key)
    shape = tuple(int(d) for d in leaf.shape)
    if name.endswith("pos") or len(shape) == 0:
        return ()
    stacked = name.startswith("layer_caches")
    body = shape[1:] if stacked else shape
    spec: list = [None] * len(body)
    if len(body) >= 1:
        spec[0] = _fit(mesh, body[0], dp_axes(mesh))       # batch dim
    if len(body) == 4:                     # (B, S, Hkv, D) | (B, H, N, P)
        if name.endswith(("/k", "/v")):
            spec[2] = _fit(mesh, body[2], "model")
        if "state" in name:
            spec[1] = _fit(mesh, body[1], "model")         # SSD heads
    if stacked:
        spec = [None] + spec
    return tuple(spec)


def serve_shardings(state, mesh):
    """Spec tree of a serve state (:func:`cache_pspec` per leaf)."""
    from repro_torch.train.checkpoint import _map_with_path
    return _map_with_path(state, lambda key, leaf: cache_pspec(
        key, leaf, mesh))


def lm_batch_axes(mesh, over_model: bool = False) -> Tuple[str, ...]:
    """The axes an LM step splits each microbatch's rows over: the DP
    axes, and ``model`` too with ``over_model`` (``batch_over_model``).
    The mesh train step splits the rows over all of them
    (:func:`repro_torch.train.train_loop.make_train_step`)."""
    extra = ("model",) if over_model and "model" in axis_names(mesh) \
        else ()
    return dp_axes(mesh) + extra


def lm_row_axes(mesh, rows: int, over_model: bool = False
                ) -> Tuple[str, ...]:
    """The axes of more than one rank an LM step splits a microbatch of
    ``rows`` rows over: as many of :func:`lm_batch_axes` as divide them
    (:func:`_fit`, as :func:`batch_pspec`); the rows are replicated over
    the rest."""
    return live_axes(mesh, _fit(mesh, rows, lm_batch_axes(mesh, over_model)))


# ------------------------------------------------------------ TNN rules

def tnn_column_size(mesh=None) -> int:
    """Size of the mesh's ``column`` axis (1 without a mesh or such an
    axis): the divisor a column count must divide for the sharded RNL
    wrappers to tile it."""
    return _sizes(mesh).get(TNN_COLUMN_AXIS, 1)


def _device_mesh(inner: str, n_inner: Optional[int], n_data: int,
                 devices: Optional[Sequence[int]], device_type: str):
    """DeviceMesh with ``("data", inner)`` dims over the world's ranks: the
    shared body of :func:`tnn_mesh` and :func:`lm_mesh`."""
    if devices is None:
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("a mesh needs an initialised process group "
                               "(torch.distributed.init_process_group)")
        devices = range(dist.get_world_size())
    devices = list(devices)
    if n_data <= 0:
        raise ValueError(f"n_data must be positive, got {n_data}")
    if n_inner is None:
        if len(devices) % n_data:
            raise ValueError(
                f"n_data={n_data} does not divide {len(devices)} devices")
        n_inner = len(devices) // n_data
    if n_inner <= 0:
        raise ValueError(f"n_{inner} must be positive, got {n_inner}")
    need = n_data * n_inner
    if need > len(devices):
        raise ValueError(f"mesh ({n_data}, {n_inner}) needs {need} "
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
    return DeviceMesh(device_type, ranks.reshape(n_data, n_inner),
                      mesh_dim_names=("data", inner))


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
    return _device_mesh(TNN_COLUMN_AXIS, n_column, n_data, devices,
                        device_type)


def lm_mesh(n_model: Optional[int] = None, n_data: int = 1, *,
            devices: Optional[Sequence[int]] = None,
            device_type: str = "cuda"):
    """DeviceMesh with ``("data", "model")`` dims over the world's ranks:
    the counterpart of ``jax.make_mesh((data_par, model_par), ("data",
    "model"))``, with :func:`tnn_mesh`'s defaults and checks (``n_model``
    defaults to every rank ``n_data`` leaves; NCCL for ``cuda``, gloo for
    ``cpu``)."""
    return _device_mesh("model", n_model, n_data, devices, device_type)


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


def coordinate(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis``."""
    return _coords(mesh)[axis]


def is_origin(mesh) -> bool:
    """Whether this rank sits at coordinate 0 on every mesh dim."""
    return not any(_coords(mesh).values())


def _axes(entry: Axis) -> Tuple[str, ...]:
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """Every axis name a spec names."""
    return tuple(a for entry in spec if entry is not None
                 for a in _axes(entry))


def block_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of a rank's block of a whole tensor of ``shape`` under the
    resolved ``spec`` (each entry's axes divide their dim)."""
    return tuple(int(d) // axis_size(mesh, e)
                 for d, e in zip(shape, spec)) + tuple(shape[len(spec):])


def spec_minus(rest: Spec, keep: Spec) -> Spec:
    """The entries of ``rest`` that ``keep`` does not keep: what a step
    gathers of a block laid out by ``rest`` to use it laid out by
    ``keep``, and cuts again after."""
    return tuple(None if k is not None else r for r, k in zip(rest, keep))


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


def rank_table(mesh) -> list:
    """The mesh's global ranks by coordinate, as nested lists of Python
    ints, read once a mesh. The read runs with any fake tensor mode set
    aside, so a step traced under ``FakeTensorMode`` on a fake mesh (the
    dry run, :mod:`repro_torch.launch.dryrun`) never reads a tensor."""
    def read():
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        with unset_fake_temporarily():
            return mesh.mesh.tolist()
    return memo(mesh, "ranks", read)


def _gather_plan(mesh, axis: str):
    """This rank's group along ``axis``, its size, and the order that puts
    the group's all-gather pieces (which come in the group's rank order)
    in the order of their coordinate on ``axis`` (``None`` where the two
    orders agree)."""
    group = mesh.get_group(axis)
    members = dist.get_process_group_ranks(group)
    d = axis_names(mesh).index(axis)
    coord = list(_coords(mesh).values())
    order = []
    for i in range(_sizes(mesh)[axis]):
        coord[d] = i
        rank = rank_table(mesh)
        for c in coord:
            rank = rank[c]
        order.append(members.index(rank))
    return group, len(members), (None if order == sorted(order)
                                 else order)


def _all_gather(x: torch.Tensor, dim: int, axis: str, mesh) -> torch.Tensor:
    """``x``'s pieces from every rank of this rank's ``axis`` group,
    concatenated along ``dim`` in coordinate order: one
    ``all_gather_into_tensor`` (gloo and NCCL both take it) into a
    buffer of the pieces stacked along dim 0."""
    group, n, order = memo(mesh, ("gather", axis),
                           lambda: _gather_plan(mesh, axis))
    x = x.detach().contiguous()
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


def shard_tree(tree, spec_tree, mesh):
    """This rank's blocks of a whole tree under its spec tree
    (:func:`param_pspecs`), leaf by leaf (:func:`shard_of`); ``None``
    subtrees stay ``None``."""
    from repro_torch.train.checkpoint import _map_with_path
    specs_of = _spec_table(spec_tree)
    return _map_with_path(tree, lambda key, leaf: shard_of(
        leaf, specs_of[key], mesh))


def put_block(dst: torch.Tensor, whole: torch.Tensor, spec: Spec, mesh
              ) -> torch.Tensor:
    """Write this rank's block of ``whole`` under the resolved ``spec``
    into ``dst`` (that block's buffer) and return ``dst``; nothing is
    written where ``whole`` is ``dst`` (a leaf :func:`gather` left as it
    was)."""
    if whole is not dst:
        idx = tuple(block_slice(mesh, d, e) if mesh is not None
                    else slice(None) for d, e in zip(whole.shape, spec))
        dst.copy_(whole[idx])
    return dst


def put_blocks(tree, whole_tree, spec_tree, mesh):
    """:func:`put_block` leaf by leaf: ``tree`` (this rank's blocks)
    holding its blocks of ``whole_tree``, returned."""
    from repro_torch.train.checkpoint import _map_with_path
    specs_of = _spec_table(spec_tree)
    wholes: Dict[str, torch.Tensor] = {}
    _map_with_path(whole_tree, lambda key, leaf: wholes.setdefault(key, leaf))
    return _map_with_path(tree, lambda key, leaf: put_block(
        leaf, wholes[key], specs_of[key], mesh))


def gather_tree(tree, spec_tree, mesh, to=None):
    """The whole tree from this rank's blocks under its spec tree, leaf by
    leaf (:func:`gather`, a collective on every rank); the inverse of
    :func:`shard_tree`. ``to``: a device each whole leaf moves to as soon
    as it is gathered (``"cpu"``: a device holds one whole leaf at a
    time)."""
    from repro_torch.train.checkpoint import _map_with_path
    specs_of = _spec_table(spec_tree)

    def one(key, leaf):
        whole = gather(leaf, specs_of[key], mesh)
        return whole if to is None else whole.to(to)
    return _map_with_path(tree, one)


def _spec_table(spec_tree) -> Dict[str, Spec]:
    """Key string -> spec of a spec tree. A spec is a tuple, which the
    checkpoint walker would enter, so the specs are read beside a walk of
    the tree they describe: a spec tree's leaves sit where a dict, a
    NamedTuple or ``None`` does not."""
    table: Dict[str, Spec] = {}

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (str(k),))
        elif isinstance(node, tuple) and hasattr(node, "_fields"):
            for f, v in zip(node._fields, node):
                walk(v, path + (f".{f}",))
        else:
            table["/".join(path)] = tuple(node)
    walk(spec_tree, ())
    return table


# ---------------------------------------------- collectives under autograd
#
# The LM mesh path differentiates through its collectives. Each function
# below names the axes it spans; an axis of one rank needs no collective,
# so on a mesh of one rank every one of them is the identity, forward and
# backward.

def live_axes(mesh, axes: Axis) -> Tuple[str, ...]:
    """``axes``' names that span more than one rank (none without a
    mesh)."""
    if mesh is None or axes is None:
        return ()
    sizes = _sizes(mesh)
    return tuple(a for a in _axes(axes) if sizes[a] > 1)


def all_reduce(x: torch.Tensor, axes: Axis, mesh, op: str = "sum",
               copy: bool = True) -> torch.Tensor:
    """The sum (``op="max"``: the largest value) of ``x`` over every rank
    of ``axes``, elementwise (a new tensor, or with ``copy=False`` ``x``
    itself, reduced in place; ``x`` itself when every axis has one rank).
    No gradient."""
    live = live_axes(mesh, axes)
    if not live:
        return x
    x = x.detach().clone() if copy else x.detach()
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    for a in live:
        dist.all_reduce(x, op=red, group=memo(
            mesh, ("group", a), lambda a=a: mesh.get_group(a)))
    return x


class _SumOver(torch.autograd.Function):
    """Forward: the sum over the axes' ranks. Backward: the identity — the
    gradient of the sum is replicated over those ranks already, and each
    rank's part gets it unchanged (an all-reduce there would count it once
    a rank)."""

    @staticmethod
    def forward(ctx, x, axes, mesh):
        return all_reduce(x, axes, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    """Forward: the identity on a tensor replicated over the axes' ranks,
    each of which uses it for a part of the result. Backward: the sum of
    the parts' gradients over those ranks."""

    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axes, ctx.mesh), None, None


class _MeanOver(torch.autograd.Function):
    """Forward: the mean over the axes' ranks (``jax.lax.pmean``).
    Backward: the gradient over the rank count, on each rank — the mean's
    gradient is replicated, and each rank's term enters it once."""

    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.n = axis_size(mesh, live_axes(mesh, axes))
        return all_reduce(x, axes, mesh) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


class _CountOnce(torch.autograd.Function):
    """Forward: the identity on a value computed whole on every rank of
    the axes. Backward: the gradient over the rank count, so that a sum of
    the ranks' gradients counts the value once."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def _block(x: torch.Tensor, dim: int, entry: Axis, mesh) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` over ``entry``."""
    rows = block_slice(mesh, x.shape[dim], entry)
    return x.narrow(dim, rows.start, rows.stop - rows.start).contiguous()


def _along(op: str, x: torch.Tensor, dim: int, entry: Axis, mesh
           ) -> torch.Tensor:
    """One of the three moves along ``dim`` over ``entry``: ``"gather"``
    the ranks' blocks joined (:func:`gather`), ``"scatter"`` the sum over
    the ranks with this rank's block kept (a reduce-scatter), ``"split"``
    this rank's block of a tensor whole on every rank."""
    if op == "gather":
        return gather(x, (None,) * dim + (entry,), mesh)
    if op == "scatter":
        x = all_reduce(x, entry, mesh)
    return _block(x, dim, entry, mesh)


class _Along(torch.autograd.Function):
    """A move along a dim over an entry's ranks (:func:`_along`), whose
    backward is another: the pairs are :func:`gather_along`,
    :func:`scatter_along` and :func:`split_along`."""

    @staticmethod
    def forward(ctx, x, fwd, bwd, dim, entry, mesh):
        ctx.bwd, ctx.dim, ctx.entry, ctx.mesh = bwd, dim, entry, mesh
        return _along(fwd, x, dim, entry, mesh)

    @staticmethod
    def backward(ctx, g):
        return (_along(ctx.bwd, g, ctx.dim, ctx.entry, ctx.mesh),
                None, None, None, None, None)


def sum_over(x: torch.Tensor, axes: Axis, mesh) -> torch.Tensor:
    """Differentiable sum over ``axes``' ranks (identity backward)."""
    return _SumOver.apply(x, axes, mesh) if live_axes(mesh, axes) else x


def copy_to(x: torch.Tensor, axes: Axis, mesh) -> torch.Tensor:
    """Identity whose backward sums the gradient over ``axes``' ranks."""
    return _CopyTo.apply(x, axes, mesh) if live_axes(mesh, axes) else x


def mean_over(x: torch.Tensor, axes: Axis, mesh) -> torch.Tensor:
    """Differentiable mean over ``axes``' ranks (``jax.lax.pmean``)."""
    return _MeanOver.apply(x, axes, mesh) if live_axes(mesh, axes) else x


def count_once(x: torch.Tensor, axes: Axis, mesh) -> torch.Tensor:
    """``x``, computed whole on every rank of ``axes``, with its gradient
    divided by their rank count (see :class:`_CountOnce`)."""
    live = live_axes(mesh, axes)
    return _CountOnce.apply(x, axis_size(mesh, live)) if live else x


def gather_along(x: torch.Tensor, dim: int, entry: Axis, mesh, *,
                 summed: bool = True) -> torch.Tensor:
    """Differentiable :func:`gather` of dim ``dim`` over ``entry``. The
    backward reduce-scatters: each rank used the whole tensor for its own
    part, and the parts' gradients are summed before each rank keeps its
    block. ``summed=False``: each rank computes the same whole result from
    the gathered tensor, so its gradient is already the whole one, and
    the backward only keeps this rank's block."""
    if not live_axes(mesh, entry):
        return x
    return _Along.apply(x, "gather", "scatter" if summed else "split", dim,
                        entry, mesh)


def scatter_along(x: torch.Tensor, dim: int, entry: Axis, mesh
                  ) -> torch.Tensor:
    """The sum of ``x`` over ``entry``'s ranks, this rank's block along
    ``dim`` kept (reduce-scatter forward); the backward all-gathers the
    blocks' gradients (Megatron's sequence-parallel reduce-scatter)."""
    if not live_axes(mesh, entry):
        return x
    return _Along.apply(x, "scatter", "gather", dim, entry, mesh)


def split_along(x: torch.Tensor, dim: int, entry: Axis, mesh
                ) -> torch.Tensor:
    """This rank's block along ``dim`` of ``x``, whole and the same on
    every rank of ``entry``; the backward all-gathers the blocks'
    gradients, so every rank's whole gradient is the whole one."""
    if not live_axes(mesh, entry):
        return x
    return _Along.apply(x, "split", "gather", dim, entry, mesh)
