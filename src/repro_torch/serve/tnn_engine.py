"""Slot-based TNN inference engine: volley batching over decode-style slots.

A *request* is a client's stream of encoded spike volleys
(:func:`repro_torch.core.coding.grf_encode`), one volley per gamma cycle.
Requests are admitted into a fixed pool of B slots
(:class:`repro_torch.serve.slots.SlotPool`); each engine step stacks the
live slots' next volleys into a ``(B, n_inputs)`` batch on the host, copies
it (with the recurrent carries) to the device in one transfer, runs one
``network.forward`` — every neuron evaluated through ``fire_times_bank`` —
and copies the ``(B, C, Q)`` output spike times back in one transfer. A
request retires the moment its stream is exhausted; its slot re-fills from
the pending queue at the top of the next step.

Recurrent streams keep their per-layer carry in their slot's ``state``:
initialised all-silent at admission, gathered into per-layer
``(B, n_outputs)`` carry batches each step (free rows stay silent, i.e.
inert), and scattered back after the cycle, so slot outputs stay bit-exact
against an unbatched per-stream reference (:func:`reference_outputs`).

Engine choice: on a CUDA device ``backend="auto"`` resolves to the fused
kernel every step. Elsewhere the engine measures each batch's density and
layer-0 active-line count on the host and lets the policy pick; the sparse
engines run with per-layer compaction widths (``network.sparse_widths``).
Every (engine, width) pair gets a network with its layers pinned to it,
kept in a bounded LRU (``max_jit_variants``). All engines are bit-exact, so
the choice never changes outputs.

Learning while serving (``TNNServeConfig.learn``): on the steps the learn
gate opens, the engine runs ``network.step`` in place of
``network.forward`` — the same pinned network, outputs at the pre-update
weights, then layer-local minibatch STDP over the whole slot batch — and
its weight state advances. A persistent ``step_id`` drives the cadence
(``stdp_every``) and seeds the stochastic rule's draws, and learning
pauses (inference never does) while the pending queue or the previous
step's wall clock is over its threshold.

Durability: with ``checkpoint_dir`` / ``checkpoint_every`` set, the engine
snapshots ``(weights, step_id, n_stdp_updates)`` through
:class:`repro_torch.train.checkpoint.CheckpointManager` in the reference's
on-disk format (the host copy is taken on the serve thread, the file
written on the manager's own thread with ``checkpoint_async``);
``TNNEngine(..., resume=True)`` restores the latest snapshot at
construction, straight onto the engine's device; :meth:`TNNEngine.restore`
rolls back to it. :func:`serve_resilient` drives the engine through
(injected) worker failures: it restores and replays every stream the
snapshot did not commit, so each retired stream is served exactly once,
bit-exact with learning off. :class:`AsyncTNNEngine` is the ``asyncio``
front door: clients ``await submit(stream)`` and one pump task steps the
shared engine.

Across GPUs (``TNNEngine(..., mesh=)``, a ``("data", "column")``
:class:`torch.distributed.device_mesh.DeviceMesh` from
:func:`repro_torch.sharding.specs.tnn_mesh`): every rank runs the same
engine on the same requests — the ``torchrun`` idiom. Each holds its block
of the weights (columns over ``column``), measures density, active lines
and widths on the whole host batch, so every rank resolves the same engine
and width, and gets the whole outputs back from ``network.forward`` /
``network.step``, which split the batch over ``data`` inside. Snapshots
are written by the rank at coordinate ``(0, 0)`` from the gathered
stacks, asynchronously as without a mesh; ``checkpoint_wait()`` ends in a
barrier behind the publish, and ``restore()`` passes it, then loads the
whole stacks on every rank and keeps the block.
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import time
import typing
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import coding, network, neuron
from repro_torch.core import policy as engine_policy
from repro_torch.kernels.common import resolve_device
from repro_torch.serve import slots
from repro_torch.sharding import specs as sharding_specs
from repro_torch.train import checkpoint as CKPT
from repro_torch.train import fault_tolerance

#: neuron-bank engines that take a compaction width
SPARSE_ENGINES = engine_policy.SPARSE_ENGINES

NO_SPIKE = coding.NO_SPIKE


@dataclasses.dataclass
class TNNServeConfig:
    """Engine knobs: slot count (= batch rows) and neuron-bank backend."""

    n_slots: int = 8
    #: fire_times_bank engine for every layer that delegates its choice:
    #: scan | closed_form | event | fused | fused_compact | auto.
    backend: neuron.Backend = "auto"
    #: how ``auto`` picks off CUDA: ``"cost"``, ``"density"``, or an
    #: :class:`repro_torch.core.policy.EnginePolicy`.
    policy: typing.Union[str, engine_policy.EnginePolicy] = "cost"
    #: gamma-cycle pipeline micro-batches per step (1 = barriered).
    pipeline_microbatches: int = 1
    #: LRU cap on the per-(engine, width) pinned networks; the default
    #: network is kept outside the cache.
    max_jit_variants: int = 8
    #: admission control: cap on the pending queue (None = unbounded).
    max_pending: Optional[int] = None
    # ----------------------------------------------- learning while serving
    #: apply per-gamma-cycle layer-local STDP to the live slot batch: a
    #: learning step runs ``network.step`` (forward + minibatch STDP over
    #: the whole batch at the pre-step weights, recurrent carries threaded)
    #: and the engine's weight state advances. Outputs are computed at the
    #: pre-update weights, so a learning step's spike times are bit-exact
    #: with the same step served learning-off.
    learn: bool = False
    #: learning cadence: STDP fires on steps where ``step_id % stdp_every
    #: == 0``. Learning steps run the barriered schedule (minibatch STDP
    #: reduces across the whole batch); the steps in between keep the
    #: configured micro-batches.
    stdp_every: int = 1
    #: None selects the deterministic expectation rule (replayable); an int
    #: seeds the stochastic rule, its generator re-seeded every step with
    #: ``stdp_step_seed(stdp_seed, step_id)``.
    stdp_seed: Optional[int] = None
    # --------------------------------------------------------- durability
    #: snapshot directory for the CheckpointManager; None disables
    #: snapshots (and makes ``resume=True`` invalid).
    checkpoint_dir: Optional[str] = None
    #: snapshot every N engine steps (0 = never). A snapshot holds the
    #: weights, ``step_id`` and ``n_stdp_updates``; a crash mid-save never
    #: corrupts the previous snapshot (atomic publish).
    checkpoint_every: int = 0
    #: rotating snapshots kept on disk (CheckpointManager ``keep``).
    checkpoint_keep: int = 3
    #: write snapshots off the serve thread (the weights are copied to the
    #: host on the serve thread first, so a later STDP update can never
    #: reach an in-flight save).
    checkpoint_async: bool = True
    #: pause learning while the pending queue holds at least this fraction
    #: of ``max_pending`` (requires ``max_pending``); learning resumes the
    #: step the pressure clears.
    learn_pause_queue_frac: Optional[float] = None
    #: pause learning while the previous step's wall clock exceeded this
    #: many seconds.
    learn_pause_step_s: Optional[float] = None


def stdp_step_seed(seed: int, step_id: int) -> int:
    """The stochastic STDP rule's generator seed for one engine step:
    ``numpy.random.SeedSequence((seed mod 2**64, step_id))
    .generate_state(1)[0]``, a 32-bit hash of the pair (the CPU generator
    reads only 32 bits of its seed). A generator on one device seeded with
    it redraws the same uniforms for the same pair."""
    return int(np.random.SeedSequence(
        (seed % 2**64, step_id)).generate_state(1)[0])


#: a slot's persistent memory: per-layer recurrent carries, ``None`` entries
#: for feedforward layers
CarryState = Tuple[Optional[np.ndarray], ...]


@dataclasses.dataclass
class TNNRequest:
    """One client's stream of volleys and its accumulated outputs."""

    req_id: int
    volleys: np.ndarray  # (n_cycles, n_inputs) int32 spike times
    outputs: List[np.ndarray] = dataclasses.field(default_factory=list)
    cursor: int = 0
    #: fraction of this request's lines carrying an in-cycle spike
    density: float = 0.0
    #: engines that served this request's cycles
    backends: set = dataclasses.field(default_factory=set)
    #: carry to seed the slot with at admission (stream continuation)
    initial_state: Optional[CarryState] = None
    #: final per-layer recurrent carries, handed back at retirement
    final_state: Optional[CarryState] = None

    @property
    def n_cycles(self) -> int:
        return int(self.volleys.shape[0])

    @property
    def done(self) -> bool:
        return self.cursor >= self.n_cycles

    def result(self) -> np.ndarray:
        """(n_cycles, C_last, Q_last) int32 post-WTA output spike times."""
        return np.stack(self.outputs, axis=0)


class TNNEngine:
    """Slot-based volley batching over a trained :class:`TNNNetwork`.

    Admission → batch → fire → retire, one gamma cycle per step. Runs on
    ``device`` (``None`` = ``cuda``, which raises when CUDA is absent).
    ``resume=True`` restores the latest snapshot under
    ``scfg.checkpoint_dir``, if there is one.

    With ``mesh`` every rank constructs the engine alike and drives it
    through the same calls (``step``, ``serve``, ``stats``, ``restore``,
    ``checkpoint_wait``: they may hold collectives); ``params`` are the
    whole stacks, the same on every rank, of which each keeps its block,
    and ``device`` defaults to the mesh's and must agree with it.
    """

    def __init__(
        self,
        params: Sequence[torch.Tensor],
        net: network.TNNNetwork,
        scfg: Optional[TNNServeConfig] = None,
        device: Union[str, torch.device, None] = None,
        resume: bool = False,
        *,
        mesh=None,
    ):
        scfg = scfg or TNNServeConfig()
        #: optional ("data", "column") device mesh: weights live as this
        #: rank's column blocks, and forward / step split the slot batch
        #: over "data"
        self.mesh = mesh
        self.device = (resolve_device(device) if mesh is None
                       else sharding_specs.mesh_device(mesh, device))
        valid = typing.get_args(neuron.Backend)
        for name, where in [(scfg.backend, "TNNServeConfig.backend")] + [
                (lc.backend, f"net.layers[{i}].backend")
                for i, lc in enumerate(net.layers)]:
            if name not in valid:
                raise ValueError(
                    f"{where}={name!r}: expected one of {valid}")
        self._policy = engine_policy.get_policy(scfg.policy)
        if scfg.backend != "auto":
            # pin only the layers that delegated the choice
            net = network.make_network([
                lc if lc.backend != "auto"
                else dataclasses.replace(lc, backend=scfg.backend)
                for lc in net.layers])
        self.net = net
        self.scfg = scfg
        self.params = self._place_params(params)
        self.stateful = any(lc.recurrent for lc in net.layers)
        self.pool: slots.SlotPool[TNNRequest, CarryState] = slots.SlotPool(
            scfg.n_slots, on_admit=self._on_admit,
            max_pending=scfg.max_pending)
        if scfg.pipeline_microbatches < 1:
            raise ValueError(
                f"pipeline_microbatches must be >= 1, got "
                f"{scfg.pipeline_microbatches}")
        self.n_stages, rows = network.microbatch_split(
            scfg.n_slots, scfg.pipeline_microbatches)
        self._stage_rows = [
            (i * rows, min((i + 1) * rows, scfg.n_slots))
            for i in range(self.n_stages)]
        self._stage_density_sums = [0.0] * self.n_stages
        #: layer-0 bank workload for the cost predictor
        self._bank_shape = engine_policy.BankShape(
            pairs=scfg.n_slots * net.layers[0].n_columns
            * net.layers[0].n_neurons,
            n_lines=net.layers[0].rf_total,
            t_steps=net.layers[0].t_steps)
        #: per-layer column counts: the shape input of the policy's mesh
        #: capability check
        self._column_counts = net.column_counts
        self._default_engine = self._policy.resolve(
            scfg.backend, device=self.device,
            column_counts=self._column_counts, mesh=mesh).engine
        if scfg.max_jit_variants < 1:
            raise ValueError(
                f"max_jit_variants must be >= 1, got {scfg.max_jit_variants}")
        # LRU over the (engine, width) pinned networks
        self._net_alt: "collections.OrderedDict[tuple, network.TNNNetwork]" \
            = collections.OrderedDict()
        self._evictions = 0
        self._t_steps = net.layers[0].t_steps
        self._rf0 = net.layers[0].rf_index(device="cpu").numpy()
        # host column ranges of each recurrent carry in the packed transfer
        offs, start = [], net.n_inputs
        for lc in net.layers:
            offs.append((start, start + lc.n_outputs) if lc.recurrent
                        else None)
            start += lc.n_outputs if lc.recurrent else 0
        self._carry_cols = tuple(offs)
        self._packed_width = start
        self._next_id = 0
        self._retired: List[slots.SlotEntry] = []
        self.n_steps = 0
        self.n_volleys = 0
        self._run_s = 0.0
        self._density_sum = 0.0
        self._backend_steps: Dict[str, int] = {}
        self._predicted_steps: Dict[str, int] = {}
        self._predicted_us_sum: Dict[str, float] = {}
        # ----------------------------------------- learning while serving
        if scfg.stdp_every < 1:
            raise ValueError(f"stdp_every must be >= 1, got "
                             f"{scfg.stdp_every}")
        if scfg.checkpoint_every < 0:
            raise ValueError(f"checkpoint_every must be >= 0, got "
                             f"{scfg.checkpoint_every}")
        if scfg.checkpoint_every and scfg.checkpoint_dir is None:
            raise ValueError("checkpoint_every > 0 needs checkpoint_dir")
        if scfg.learn_pause_queue_frac is not None:
            if scfg.max_pending is None:
                raise ValueError("learn_pause_queue_frac measures "
                                 "max_pending occupancy — set max_pending")
            if scfg.learn_pause_queue_frac <= 0.0:
                raise ValueError("learn_pause_queue_frac must be > 0")
        #: persistent engine-step counter: unlike ``n_steps`` it survives
        #: ``reset_stats`` and restores with snapshots; the STDP cadence,
        #: the snapshot schedule and the stochastic rule's seeds key off
        #: it, so a restored engine replays the same decisions.
        self.step_id = 0
        self.n_stdp_updates = 0
        self.n_snapshots = 0
        self.n_restores = 0
        self.learning_paused = False
        self.n_learn_pauses = 0
        self._last_step_s = 0.0
        self._stdp_gen: Optional[torch.Generator] = None
        self._ckpt: Optional[CKPT.CheckpointManager] = None
        if scfg.checkpoint_dir is not None and scfg.checkpoint_every > 0:
            self._ckpt = CKPT.CheckpointManager(
                scfg.checkpoint_dir, keep=scfg.checkpoint_keep,
                every=scfg.checkpoint_every,
                async_save=scfg.checkpoint_async)
        if resume:
            if self._ckpt is None:
                raise ValueError("resume=True needs checkpoint_dir and "
                                 "checkpoint_every > 0")
            if CKPT.latest_step(self._ckpt.dir) is not None:
                self.restore()
        # the weights this instance came up with (after a resume), whole,
        # on the host: the reference of the per-layer drift norms in
        # stats(), and what restore() rolls back to while no snapshot is on
        # disk
        self._params_host0 = tuple(p.detach().cpu().numpy().copy()
                                   for p in self.whole_params())

    def _place_params(self, params: Sequence) -> Tuple[torch.Tensor, ...]:
        """Whole weight stacks -> float32 tensors on the engine's device,
        and under a mesh this rank's blocks of them; shared by
        construction and :meth:`restore`."""
        placed = tuple(torch.as_tensor(p, dtype=torch.float32)
                       .to(self.device) for p in params)
        if self.mesh is None:
            return placed
        return tuple(
            sharding_specs.maybe_wsc(
                sharding_specs.shard_of(p, spec, self.mesh),
                *sharding_specs.tnn_param_axes(), mesh=self.mesh,
                shape=(lc.n_columns, lc.n_neurons, lc.rf_total))
            for p, lc, spec in zip(placed, self.net.layers,
                                   network.param_shardings(self.net,
                                                           self.mesh)))

    def whole_params(self) -> Tuple[torch.Tensor, ...]:
        """The whole weight stacks: the engine's own without a mesh, else
        gathered from every rank's blocks (a collective: every rank
        calls it)."""
        if self.mesh is None:
            return tuple(self.params)
        return tuple(sharding_specs.gather(p, spec, self.mesh)
                     for p, spec in zip(self.params, network.param_shardings(
                         self.net, self.mesh)))

    def _stdp_key(self) -> Optional[torch.Generator]:
        """This step's STDP generator: ``None`` (the expectation rule)
        unless ``stdp_seed`` is set; then the engine's generator on its
        device, seeded with :func:`stdp_step_seed` of ``(stdp_seed,
        step_id)``, so a replay of a step redraws the same uniforms."""
        if self.scfg.stdp_seed is None:
            return None
        if self._stdp_gen is None:
            self._stdp_gen = torch.Generator(device=self.device)
        return self._stdp_gen.manual_seed(
            stdp_step_seed(self.scfg.stdp_seed, self.step_id))

    def _learn_gate(self) -> bool:
        """Should THIS step apply STDP? Learning pauses (inference never
        does) while the pending queue's occupancy or the previous step's
        wall clock sits above its threshold, and resumes the step the
        pressure clears; pause transitions are counted. Otherwise it learns
        when ``step_id % stdp_every == 0``."""
        scfg = self.scfg
        if not scfg.learn:
            return False
        pressured = (
            scfg.learn_pause_queue_frac is not None
            and self.pool.pending_occupancy >= scfg.learn_pause_queue_frac
        ) or (
            scfg.learn_pause_step_s is not None
            and self._last_step_s > scfg.learn_pause_step_s
        )
        if pressured:
            if not self.learning_paused:
                self.learning_paused = True
                self.n_learn_pauses += 1
            return False
        self.learning_paused = False
        return self.step_id % scfg.stdp_every == 0

    def _snapshot_state(self) -> Dict[str, object]:
        """What a snapshot holds: the whole weight stacks and the
        persistent counters (``step_id``, ``n_stdp_updates``), enough for a
        restored engine to make the original run's cadence, seed and
        snapshot decisions."""
        return {
            "params": self.whole_params(),
            "counters": np.asarray(
                [self.step_id, self.n_stdp_updates], np.int32),
        }

    def _maybe_snapshot(self) -> None:
        """Hand the step's state to the CheckpointManager on the
        ``checkpoint_every`` cadence. The manager copies it to the host
        here, on the serve thread (a device-to-host copy, so a sync), and
        with ``checkpoint_async`` writes it on its own thread.

        Under a mesh every rank gathers the stacks and the rank at
        coordinate ``(0, 0)`` alone hands them to its manager, which
        writes them as without a mesh (on its thread with
        ``checkpoint_async``). No rank reads a snapshot before
        :meth:`checkpoint_wait`'s barrier, which :meth:`restore` passes
        first."""
        if self._ckpt is None:
            return
        if self.mesh is None:
            if self._ckpt.maybe_save(self.step_id, self._snapshot_state()):
                self.n_snapshots += 1
            return
        if self.step_id % self._ckpt.every:
            return
        state = self._snapshot_state()
        if sharding_specs.is_origin(self.mesh):
            self._ckpt.maybe_save(self.step_id, state)
        self.n_snapshots += 1

    def checkpoint_wait(self) -> None:
        """Block until any in-flight async snapshot has published; under a
        mesh, until every rank has got here too (a barrier behind the
        writer's publish)."""
        if self._ckpt is not None:
            self._ckpt.wait()
            if self.mesh is not None:
                sharding_specs.barrier(self.mesh)

    def restore(self) -> int:
        """Roll the engine back to the latest snapshot, or, with none on
        disk yet, to the weights it came up with (construction is the
        implicit step-0 commit point). Restores the weights, onto the
        engine's device as float32, and the persistent counters, then
        drops every live and pending stream (``pool.clear()``): their
        partial progress was computed at weights that no longer exist, so
        the caller (:func:`serve_resilient`) resubmits every stream the
        snapshot did not commit, from its beginning. Returns the restored
        step id."""
        if self._ckpt is None:
            raise ValueError(
                "restore() needs checkpoint_dir and checkpoint_every > 0")
        self.checkpoint_wait()
        step = CKPT.latest_step(self._ckpt.dir)
        if step is None:
            self.params = self._place_params(self._params_host0)
            self.step_id = 0
            self.n_stdp_updates = 0
        else:
            template = {
                "params": tuple(self.params),
                "counters": np.zeros(2, np.int32),
            }
            state = CKPT.restore_checkpoint(self._ckpt.dir, template, step)
            # the whole stacks, of which a rank on a mesh keeps its block
            self.params = self._place_params(state["params"])
            self.step_id = int(state["counters"][0])
            self.n_stdp_updates = int(state["counters"][1])
        self.pool.clear()
        self.learning_paused = False
        self._last_step_s = 0.0
        self.n_restores += 1
        return self.step_id

    def _on_admit(self, idx: int, entry: slots.SlotEntry) -> None:
        """Pool lifecycle hook: initialise the slot's per-layer recurrent
        state all-silent, or from the request's ``initial_state``."""
        del idx
        req = entry.item
        if req is not None and req.initial_state is not None:
            entry.state = req.initial_state
            return
        if self.stateful:
            entry.state = tuple(
                np.full((lc.n_outputs,), NO_SPIKE, np.int32)
                if lc.recurrent else None
                for lc in self.net.layers)

    def reset_stats(self) -> None:
        """Zero the throughput/latency accounting; pending/live requests
        are untouched."""
        self._retired.clear()
        self.n_steps = 0
        self.n_volleys = 0
        self._run_s = 0.0
        self._density_sum = 0.0
        self._stage_density_sums = [0.0] * self.n_stages
        self._backend_steps = {}
        self._predicted_steps = {}
        self._predicted_us_sum = {}
        self.pool.n_retired = 0
        self.pool.n_rejected = 0
        self.pool.n_submitted = self.pool.n_live + self.pool.n_pending

    def submit(self, volleys: np.ndarray,
               initial_state: Optional[CarryState] = None) -> TNNRequest:
        """Enqueue one request: ``(n_cycles, n_inputs)`` int32 spike times
        (a single ``(n_inputs,)`` volley is promoted to one cycle).

        ``initial_state`` seeds the slot's recurrent carry at admission.
        Raises :class:`repro_torch.serve.slots.QueueFull` when the queue is
        at ``max_pending``."""
        volleys = np.asarray(volleys, np.int32)
        if volleys.ndim == 1:
            volleys = volleys[None, :]
        if volleys.ndim != 2 or volleys.shape[1] != self.net.n_inputs:
            raise ValueError(
                f"expected (n_cycles, {self.net.n_inputs}) volleys, got "
                f"{volleys.shape}")
        if volleys.shape[0] == 0:
            raise ValueError("empty volley stream")
        if (volleys < 0).any():
            raise ValueError(
                "volleys must be non-negative spike times "
                f"(NO_SPIKE={NO_SPIKE} for silent lines); got min "
                f"{int(volleys.min())}")
        if initial_state is not None:
            if not self.stateful:
                raise ValueError(
                    "initial_state given for a feedforward network")
            if len(initial_state) != len(self.net.layers):
                raise ValueError(
                    f"initial_state has {len(initial_state)} entries for "
                    f"{len(self.net.layers)} layers")
            initial_state = tuple(
                None if c is None
                else np.asarray(c, np.int32).reshape(lc.n_outputs)
                for c, lc in zip(initial_state, self.net.layers))
        req = TNNRequest(
            req_id=self._next_id, volleys=volleys,
            density=float(np.mean(volleys < self._t_steps)),
            initial_state=initial_state)
        self.pool.submit(req)
        self._next_id += 1
        return req

    def _layer0_active(self, batch: np.ndarray) -> int:
        """Max active-line count over the batch's layer-0 receptive
        fields (exact, so no active line can drop)."""
        active = batch[:, self._rf0] < self._t_steps  # (B, C, rf)
        return int(active.sum(axis=-1).max()) if active.size else 0

    def _net_for(self, engine: str,
                 first_width: Optional[int] = None) -> network.TNNNetwork:
        """The network with its ``auto`` layers pinned to ``engine``;
        sparse engines also pin per-layer compaction widths
        (``network.sparse_widths`` seeded with ``first_width``). Kept in an
        LRU of ``scfg.max_jit_variants`` entries."""
        if engine == self._default_engine and first_width is None:
            return self.net
        key = (engine, first_width)
        if key in self._net_alt:
            self._net_alt.move_to_end(key)
            return self._net_alt[key]
        widths = (network.sparse_widths(self.net, first_width)
                  if first_width is not None
                  else (None,) * len(self.net.layers))
        layers = []
        for lc, width in zip(self.net.layers, widths):
            eff = engine if lc.backend == "auto" else lc.backend
            layers.append(dataclasses.replace(
                lc, backend=eff,
                n_active_max=(width if eff in SPARSE_ENGINES
                              else lc.n_active_max)))
        pinned = network.make_network(layers)
        self._net_alt[key] = pinned
        while len(self._net_alt) > self.scfg.max_jit_variants:
            self._net_alt.popitem(last=False)
            self._evictions += 1
        return pinned

    def step(self) -> List[TNNRequest]:
        """One gamma cycle for every live slot; returns requests retired
        this step (in ascending slot order)."""
        t0 = time.perf_counter()
        self.pool.admit()
        live = list(self.pool.live())
        if not live:
            return []
        # batch and carries packed side by side: one host-to-device copy
        packed = np.full((self.scfg.n_slots, self._packed_width), NO_SPIKE,
                         np.int32)
        n_in = self.net.n_inputs
        for idx, entry in live:
            req = entry.item
            packed[idx, :n_in] = req.volleys[req.cursor]
            if self.stateful:
                for cols, s in zip(self._carry_cols, entry.state):
                    if cols is not None:
                        packed[idx, cols[0]:cols[1]] = s
        batch = packed[:, :n_in]
        density = float(np.mean(batch < self._t_steps))
        if self.n_stages > 1:
            for i, (lo, hi) in enumerate(self._stage_rows):
                self._stage_density_sums[i] += float(
                    np.mean(batch[lo:hi] < self._t_steps))
        # the active-line count only matters where the policy weighs it or
        # a sparse engine sizes its compaction width from it
        needs_active = (self.scfg.backend in SPARSE_ENGINES
                        or self._policy.wants_density(self.scfg.backend,
                                                      self.device))
        # measured on the whole host batch, so under a mesh every rank
        # resolves the same engine and width
        res = self._policy.resolve(
            self.scfg.backend, density=density,
            max_active=self._layer0_active(batch) if needs_active else None,
            column_counts=self._column_counts, shape=self._bank_shape,
            device=self.device, mesh=self.mesh)
        engine = res.engine
        self._density_sum += density
        self._backend_steps[engine] = self._backend_steps.get(engine, 0) + 1
        if res.predicted_us:
            want = min(res.predicted_us, key=res.predicted_us.__getitem__)
            self._predicted_steps[want] = \
                self._predicted_steps.get(want, 0) + 1
            for name, us in res.predicted_us.items():
                self._predicted_us_sum[name] = \
                    self._predicted_us_sum.get(name, 0.0) + us
        width = res.width if engine in SPARSE_ENGINES else None
        dev = torch.from_numpy(packed).to(self.device)
        carry_in = tuple(None if cols is None else dev[:, cols[0]:cols[1]]
                         for cols in self._carry_cols)
        net = self._net_for(engine, width)
        if self._learn_gate():
            # outputs at the pre-update weights (bit-exact with the
            # inference path); the new weights advance the engine's state
            result = network.step(self.params, dev[:, :n_in], net,
                                  key=self._stdp_key(), carry=carry_in,
                                  mesh=self.mesh)
            self.params = result.params
            self.n_stdp_updates += 1
        else:
            result = network.forward(self.params, dev[:, :n_in], net,
                                     microbatches=self.n_stages,
                                     carry=carry_in, mesh=self.mesh)
        # outputs and new carries side by side: one device-to-host copy
        flat_out = result.out.reshape(self.scfg.n_slots, -1)
        parts = [flat_out] + [c for c in result.carry if c is not None]
        host = torch.cat(parts, dim=1).cpu().numpy()
        out = host[:, :flat_out.shape[1]].reshape(result.out.shape)
        carry_out, col = [], flat_out.shape[1]
        for c in result.carry:
            if c is None:
                carry_out.append(None)
            else:
                carry_out.append(host[:, col:col + c.shape[1]])
                col += c.shape[1]
        retired: List[TNNRequest] = []
        for idx, entry in live:
            req = entry.item
            req.backends.add(engine)
            req.outputs.append(out[idx].copy())
            req.cursor += 1
            if self.stateful:
                entry.state = tuple(
                    None if c is None else c[idx].copy() for c in carry_out)
            if req.done:
                done_entry = self.pool.retire(idx)
                req.final_state = done_entry.state
                # keep only the timestamps for the latency summary
                self._retired.append(
                    dataclasses.replace(done_entry, item=None, state=None))
                retired.append(req)
        self.n_steps += 1
        self.n_volleys += len(live)
        # the persistent counter advances after the step's retirements and
        # before the snapshot, so a snapshot at step s commits every stream
        # retired at or before s (serve_resilient's commit rule), and no
        # snapshot is taken at step 0
        self.step_id += 1
        self._maybe_snapshot()
        dt = time.perf_counter() - t0
        self._last_step_s = dt
        self._run_s += dt
        return retired

    def run(self) -> List[TNNRequest]:
        """Drain pending + live work; returns requests in completion order."""
        finished: List[TNNRequest] = []
        while self.pool.has_work:
            finished.extend(self.step())
        return finished

    def serve(self, streams: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Synchronous front door: results in submission order."""
        reqs = [self.submit(s) for s in streams]
        self.run()
        return [r.result() for r in reqs]

    def stats(self) -> Dict[str, float]:
        """Throughput + occupancy + per-request latency summary."""
        out = {
            "n_steps": float(self.n_steps),
            "n_volleys": float(self.n_volleys),
            "n_retired": float(self.pool.n_retired),
            "n_rejected": float(self.pool.n_rejected),
            "run_s": self._run_s,
        }
        if self._run_s > 0.0:
            out["volleys_per_s"] = self.n_volleys / self._run_s
        if self.n_steps > 0:
            out["slot_occupancy"] = self.n_volleys / (
                self.n_steps * self.scfg.n_slots)
            out["density_mean"] = self._density_sum / self.n_steps
        out["pipeline_microbatches"] = float(self.n_stages)
        if self.n_steps > 0 and self.n_stages > 1:
            for i, total in enumerate(self._stage_density_sums):
                out[f"density_stage{i}_mean"] = total / self.n_steps
        for engine, steps in self._backend_steps.items():
            out[f"steps_{engine}"] = float(steps)
        out["policy_mode"] = 1.0 if self._policy.mode == "cost" else 0.0
        for engine, steps in self._predicted_steps.items():
            out[f"steps_predicted_{engine}"] = float(steps)
        for engine, us in self._predicted_us_sum.items():
            if self.n_steps > 0:
                out[f"predicted_us_mean_{engine}"] = us / self.n_steps
        # pinned-network cache: live entries + total drops
        out["jit_variants"] = float(len(self._net_alt))
        out["jit_evictions"] = float(self._evictions)
        out["step_id"] = float(self.step_id)
        out["n_stdp_updates"] = float(self.n_stdp_updates)
        out["n_snapshots"] = float(self.n_snapshots)
        out["n_restores"] = float(self.n_restores)
        out["learning_paused"] = float(self.learning_paused)
        out["n_learn_pauses"] = float(self.n_learn_pauses)
        if self.scfg.learn:
            # per-layer L2 drift against the weights this instance came up
            # with (after a resume): how far live traffic has moved each
            # stack (whole stacks: under a mesh, a gather on every rank)
            for i, (p, p0) in enumerate(zip(self.whole_params(),
                                            self._params_host0)):
                out[f"weight_drift_l{i}"] = float(np.linalg.norm(
                    p.detach().cpu().numpy().astype(np.float64)
                    - p0.astype(np.float64)))
        out.update(slots.latency_summary(self._retired))
        return out


class AsyncTNNEngine:
    """``asyncio`` front door over a shared :class:`TNNEngine`.

    Clients ``await submit(stream)`` concurrently; a single pump task steps
    the engine while work remains, resolving each request's future when it
    retires. A step is synchronous (it ends in its device-to-host copy), so
    the pump's ``await asyncio.sleep(0)`` between steps is where other
    clients run: admission stays continuous under bursts of submissions.

    Admission rejections (``max_pending`` hit, :class:`slots.QueueFull`)
    are absorbed by a bounded retry: the submitter backs off
    ``submit_retry_delay_s`` (with the pump kept running, so each backoff
    gives the engine a chance to drain the queue) up to ``submit_retries``
    times before the exception reaches the caller.
    """

    def __init__(
        self,
        engine: TNNEngine,
        *,
        submit_retries: int = 3,
        submit_retry_delay_s: float = 0.02,
    ):
        if submit_retries < 0:
            raise ValueError(
                f"submit_retries must be >= 0, got {submit_retries}")
        if submit_retry_delay_s < 0:
            raise ValueError(f"submit_retry_delay_s must be >= 0, got "
                             f"{submit_retry_delay_s}")
        self.engine = engine
        self.submit_retries = submit_retries
        self.submit_retry_delay_s = submit_retry_delay_s
        self._futures: Dict[int, asyncio.Future] = {}
        self._pump_task: Optional[asyncio.Task] = None

    async def submit(self, volleys: np.ndarray) -> np.ndarray:
        """Submit one stream; resolves to its (n_cycles, C, Q) output.

        A full pending queue is retried ``submit_retries`` times with
        ``submit_retry_delay_s`` backoff; :class:`slots.QueueFull`
        propagates once the budget is spent (each rejected attempt still
        counts in ``stats()["n_rejected"]``)."""
        for attempt in range(self.submit_retries + 1):
            try:
                req = self.engine.submit(volleys)
                break
            except slots.QueueFull:
                if attempt == self.submit_retries:
                    raise
                # keep the pump stepping so the queue can drain while this
                # submitter backs off
                self._ensure_pump()
                await asyncio.sleep(self.submit_retry_delay_s)
        fut = asyncio.get_running_loop().create_future()
        self._futures[req.req_id] = fut
        self._ensure_pump()
        return await fut

    def _ensure_pump(self) -> None:
        if self._pump_task is None or self._pump_task.done():
            self._pump_task = asyncio.get_running_loop().create_task(
                self._pump())

    async def _pump(self) -> None:
        try:
            while self.engine.pool.has_work:
                for req in self.engine.step():
                    fut = self._futures.pop(req.req_id, None)
                    if fut is not None and not fut.done():
                        fut.set_result(req.result())
                # yield so freshly woken clients can enqueue before the
                # next admission
                await asyncio.sleep(0)
        except Exception as exc:
            # a dead pump must not strand waiting clients: fail them all.
            # No re-raise: every request holds a future, so the error is
            # delivered; the pump task itself is never awaited.
            for fut in self._futures.values():
                if not fut.done():
                    fut.set_exception(exc)
            self._futures.clear()


def serve_resilient(
    engine: TNNEngine,
    streams: Sequence[np.ndarray],
    *,
    failure_injector: Optional[Callable[[int], None]] = None,
    max_restarts: int = 3,
    monitor: Optional[fault_tolerance.HeartbeatMonitor] = None,
) -> Tuple[List[np.ndarray], dict]:
    """Serving that survives worker failures: the ``run_resilient`` idiom
    for the serve path.

    Feeds ``streams`` through the engine (incrementally, so a bounded
    pending queue never rejects the batch), stepping until everything
    retires. ``failure_injector(step_id)``, called before each step, may
    raise :class:`~repro_torch.train.fault_tolerance.WorkerFailure`; the
    loop then rolls the engine back to its latest snapshot
    (:meth:`TNNEngine.restore`: weights and counters, pool cleared) and
    replays every stream the snapshot did not commit, from its beginning.
    A snapshot at step ``s`` commits exactly the streams retired at or
    before ``s`` (``step_id`` advances after a step's retirements, before
    its snapshot), so each retired stream is served exactly once. With
    learning off the replayed outputs equal the uninterrupted run's bit for
    bit (slot outputs do not depend on the batch's composition); with
    learning on, the restored counters make the replay from the snapshot
    take the same STDP decisions and seeds.

    Each step beats ``monitor`` (host 0) with its wall clock when one is
    given. Returns ``(results, report)``: results in submission order, the
    report with ``restarts``, ``failed_hosts``, ``restored_steps`` and
    ``resubmitted`` (one list of stream indices per restore). Re-raises the
    failure once ``max_restarts`` is spent.
    """
    n = len(streams)
    results: List[Optional[np.ndarray]] = [None] * n
    retired_step: List[Optional[int]] = [None] * n
    report = {
        "restarts": 0,
        "failed_hosts": [],
        "restored_steps": [],
        "resubmitted": [],
    }
    todo = collections.deque(range(n))
    inflight: Dict[int, int] = {}
    restarts = 0

    def _feed() -> None:
        # fill the queue as far as admission control allows; the rest
        # waits in `todo` for freed capacity
        while todo:
            try:
                req = engine.submit(streams[todo[0]])
            except slots.QueueFull:
                break
            inflight[req.req_id] = todo.popleft()

    while True:
        try:
            _feed()
            while inflight or todo or engine.pool.has_work:
                t0 = time.perf_counter()
                if failure_injector is not None:
                    failure_injector(engine.step_id)
                for req in engine.step():
                    i = inflight.pop(req.req_id, None)
                    if i is None:
                        continue  # not ours (the caller submitted it)
                    results[i] = req.result()
                    retired_step[i] = engine.step_id
                if monitor is not None:
                    monitor.beat(0, time.perf_counter() - t0)
                _feed()
            engine.checkpoint_wait()
            return results, report
        except fault_tolerance.WorkerFailure as f:
            restarts += 1
            report["restarts"] = restarts
            report["failed_hosts"].append(f.host_id)
            if restarts > max_restarts:
                raise
            s = engine.restore()
            report["restored_steps"].append(s)
            # results recorded after step s were computed at weights that
            # no longer exist: drop them and replay those streams
            inflight.clear()
            replay = [i for i in range(n)
                      if retired_step[i] is None or retired_step[i] > s]
            for i in replay:
                results[i] = None
                retired_step[i] = None
            todo = collections.deque(replay)
            report["resubmitted"].append(replay)


def reference_outputs(params: Sequence[torch.Tensor],
                      net: network.TNNNetwork,
                      stream: np.ndarray) -> np.ndarray:
    """Unbatched oracle: each volley through ``network.forward`` alone, on
    the device of ``params``, threading the stream's own recurrent carry
    across cycles (silent for cycle 0 — a fresh stream)."""
    dev = params[0].device
    outs: List[np.ndarray] = []
    carry = None
    for volley in np.asarray(stream, np.int32):
        res = network.forward(tuple(params), torch.tensor(volley, device=dev),
                              net, carry=carry)
        carry = res.carry
        outs.append(res.out.cpu().numpy())
    return np.stack(outs, axis=0)
