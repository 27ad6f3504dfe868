"""Slot-based serving: the generic slot pool, the TNN volley engine (with
snapshots, :class:`AsyncTNNEngine` and :func:`serve_resilient`) and the LM
engine (continuous per-slot batching for the attention families, static
lockstep decoding for the others)."""

from repro_torch.serve.engine import Engine, LMRequest, ServeConfig
from repro_torch.serve.slots import QueueFull, SlotEntry, SlotPool, latency_summary
from repro_torch.serve.tnn_engine import (
    AsyncTNNEngine,
    TNNEngine,
    TNNRequest,
    TNNServeConfig,
    serve_resilient,
)

__all__ = [
    "AsyncTNNEngine",
    "Engine",
    "LMRequest",
    "QueueFull",
    "ServeConfig",
    "SlotEntry",
    "SlotPool",
    "TNNEngine",
    "TNNRequest",
    "TNNServeConfig",
    "latency_summary",
    "serve_resilient",
]
