"""What one rank's step costs, counted from the operations it dispatches.

:class:`OpCost` is a ``TorchDispatchMode`` entered around one rank's step
(on real tensors, or on fake ones under ``FakeTensorMode``: the dry run,
:mod:`repro_torch.launch.dryrun`). It stands for the reference's HLO
parsers, with these counts:

* ``flops``: ``torch.utils.flop_counter.FlopCounterMode``'s count, its
  formulas per operator (matrix products, convolutions, attention);
  ``flops_by_op`` by operator. The reference's ``roofline/hlo_cost.py``
  counts the dots of the optimised HLO, each while body times its trip
  count; here every dispatched operation is seen once per run (layers and
  microbatches are Python loops, so no trip count is needed), the
  backward's products included.
* ``bytes``: the reference's proxy, each operation's output bytes times
  two (written once, read once downstream); views (``OpOverload.is_view``)
  are not counted. XLA counts only the top level of a fusion; eager
  PyTorch fuses nothing, so every operation counts here.
* ``collectives``: the output buffers of the c10d all-gathers,
  all-reduces, reduce-scatters and all-to-alls, by kind (the reference's
  names), and their ``count`` (``roofline/analysis.collective_bytes`` in
  the reference, which parses the HLO for the same).
* ``peak_bytes``: the most bytes held at once in storages the step can
  reach: those of the arguments registered with :meth:`OpCost.hold` and
  every storage an operation returns, each freed when its last reference
  goes (a weak reference to the storage). The reference reads XLA's
  ``memory_analysis``; caching-allocator rounding and workspaces are not
  seen here.
"""

from __future__ import annotations

import weakref
from typing import Any, Dict, Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

#: c10d operations by the reference's collective kinds
COLLECTIVE_KINDS = {
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
}
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")


def _tensors(tree: Any) -> Iterable[torch.Tensor]:
    """The tensors of a tree, but those on the ``meta`` device: shapes
    the step derives its layouts from, which hold no memory."""
    if isinstance(tree, torch.Tensor):
        if tree.device.type != "meta":
            yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


def tensor_bytes(tree: Any) -> int:
    """The bytes of the tensors of a tree (dicts, tuples, lists)."""
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def aliased_bytes(out: Any, args: Any) -> int:
    """The bytes of the tensors of ``out`` whose storage is one of the
    tensors of ``args``' (a step's outputs that are its donated
    arguments)."""
    held = {t.untyped_storage()._cdata for t in _tensors(args)}
    return sum(t.numel() * t.element_size() for t in _tensors(out)
               if t.untyped_storage()._cdata in held)


class _Counts(TorchDispatchMode):
    """Bytes, collectives and live storages (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.collectives = {k: 0 for k in KINDS}
        self.collectives["count"] = 0
        self.live: Dict[int, int] = {}
        self.current = self.peak = 0

    def hold(self, tree: Any) -> None:
        for t in _tensors(tree):
            self._track(t)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return
        n = st.nbytes()
        self.live[key] = n
        self.current += n
        self.peak = max(self.peak, self.current)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.current -= self.live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func._overloadpacket.__name__
        kind = COLLECTIVE_KINDS.get(name) \
            if func.namespace == "c10d" else None
        if kind is not None:
            n = tensor_bytes(args[0])
            self.collectives[kind] += n
            self.collectives["count"] += 1
        if not func.is_view:
            self.bytes += 2 * tensor_bytes(out)
        for t in _tensors(out):
            self._track(t)
        return out


class OpCost:
    """``with OpCost() as cost: step(...)``, then ``cost.flops``,
    ``cost.flops_by_op``, ``cost.bytes``, ``cost.collectives``,
    ``cost.peak_bytes``. :meth:`hold` registers tensors that live through
    the step (its arguments) before it runs."""

    def __init__(self):
        self._counts = _Counts()
        self._flops = FlopCounterMode(display=False)

    def hold(self, tree: Any) -> None:
        self._counts.hold(tree)

    def __enter__(self) -> "OpCost":
        self._counts.__enter__()
        self._flops.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._flops.__exit__(*exc)
        self._counts.__exit__(*exc)

    @property
    def flops(self) -> int:
        return int(self._flops.get_total_flops())

    @property
    def flops_by_op(self) -> Dict[str, int]:
        counts = self._flops.get_flop_counts().get("Global", {})
        return {str(k): int(v) for k, v in counts.items()}

    @property
    def bytes(self) -> int:
        return self._counts.bytes

    @property
    def collectives(self) -> Dict[str, int]:
        return dict(self._counts.collectives)

    @property
    def collective_bytes(self) -> int:
        return sum(v for k, v in self._counts.collectives.items()
                   if k != "count")

    @property
    def peak_bytes(self) -> int:
        return self._counts.peak

    @property
    def live_bytes(self) -> int:
        """The bytes held now in the storages tracked."""
        return self._counts.current
