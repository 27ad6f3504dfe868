"""Rank bodies of the port's multi-process mesh tests, and the harness that
spawns them.

:func:`run` starts ``world`` CPU processes joined by gloo (a ``file://``
rendezvous under the test's ``tmp_path``, so no TCP port can collide),
builds the ``("data", "column")`` mesh in each and calls one body of this
module there. Spawned ranks import their body from here, never from a
test file. A body returns a dict of numpy arrays (and plain values); the
harness hands back one dict per rank, and the tests compare them with the
reference's single-device outputs in the parent process. The ranks import
torch and the port only.

The networks are the reference SETUP's (``tests/test_sharding_tnn.py``): a
2-layer stack whose columns (8, then 4) tile a 4-way column axis, and a
one-layer C=5 stack that tiles none, so it takes the replication fallback.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import tempfile
import traceback
from typing import Any, Dict, List

import numpy as np

#: seconds a spawn may take, from start to the last rank's exit
TIME_LIMIT_S = 240

NO_SPIKE = 2**31 - 1

#: the reference SETUP's layers
L1 = dict(n_columns=8, rf_size=4, n_neurons=3, threshold=5, t_steps=12,
          dendrite="catwalk", k=2)
L2 = dict(n_columns=4, rf_size=6, n_neurons=4, threshold=4, t_steps=12,
          dendrite="catwalk", k=2)
ODD = dict(L1, n_columns=5)

BACKENDS = ("scan", "closed_form", "event", "fused", "fused_compact")


def sparse_volleys(rng, bsz, n, t_max=20, t_steps=12):
    t = rng.integers(0, t_max, size=(bsz, n))
    return np.where(t >= t_steps, NO_SPIKE, t).astype(np.int32)


def draws_for(n_inputs: int) -> List[np.ndarray]:
    """The reference test's draws: three sparse batches, an all-silent
    and a fully dense one (8 volleys each)."""
    out = [sparse_volleys(np.random.default_rng(s), 8, n_inputs)
           for s in range(3)]
    out.append(np.full((8, n_inputs), NO_SPIKE, np.int32))
    out.append(np.random.default_rng(7).integers(
        0, 12, size=(8, n_inputs)).astype(np.int32))
    return out


# ----------------------------------------------------------------- harness

def _body(name: str):
    """A rank body: ``"name"`` in this module, or ``"module:name"``."""
    if ":" in name:
        import importlib
        module, name = name.split(":")
        return getattr(importlib.import_module(module), name)
    return globals()[name]


def _entry(rank: int, world: int, rdv: str, shape, body: str, args,
           out_dir: str, kind: str = "tnn") -> None:
    import torch
    import torch.distributed as dist
    # one OpenMP thread a rank, set before the rank's first parallel op
    torch.set_num_threads(1)
    path = os.path.join(out_dir, f"rank{rank}.pkl")
    try:
        dist.init_process_group("gloo", init_method=f"file://{rdv}",
                                rank=rank, world_size=world)
        from repro_torch.sharding import specs
        make = specs.lm_mesh if kind == "lm" else specs.tnn_mesh
        mesh = make(shape[1], shape[0], device_type="cpu")
        result = _body(body)(mesh, *args)
        dist.barrier()
        with open(path, "wb") as f:
            pickle.dump(("ok", result), f)
    except BaseException:
        with open(path, "wb") as f:
            pickle.dump(("error", traceback.format_exc()), f)
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run(body: str, shape, args=(), tmp_dir=None, kind: str = "tnn"
        ) -> List[Dict[str, Any]]:
    """Run ``body(mesh, *args)`` on ``shape[0] * shape[1]`` spawned gloo
    ranks over a ``(n_data, n_column) = shape`` mesh (``kind="lm"``: a
    ``(n_data, n_model)`` one, :func:`specs.lm_mesh`); returns each rank's
    result, rank by rank. ``body`` names a function of this module, or
    ``"module:function"`` of another under ``tests/``. Raises with the
    ranks' tracebacks when one fails, and when the spawn outlives
    :data:`TIME_LIMIT_S`."""
    import multiprocessing as mp
    world = int(shape[0]) * int(shape[1])
    work = tempfile.mkdtemp(dir=tmp_dir)
    rdv = os.path.join(work, "rendezvous")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry,
                         args=(r, world, rdv, tuple(shape), body, args,
                               work, kind))
             for r in range(world)]
    for p in procs:
        p.start()
    import time
    deadline = time.monotonic() + TIME_LIMIT_S
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    late = [p for p in procs if p.is_alive()]
    for p in late:
        p.terminate()
        p.join(10)
    results, errors = [], []
    for r in range(world):
        path = os.path.join(work, f"rank{r}.pkl")
        if not os.path.exists(path):
            errors.append(f"rank {r}: no result (exit {procs[r].exitcode})")
            continue
        with open(path, "rb") as f:
            status, value = pickle.load(f)
        if status == "ok":
            results.append(value)
        else:
            errors.append(f"rank {r}:\n{value}")
    if late:
        errors.append(f"{len(late)} ranks outlived {TIME_LIMIT_S} s")
    if errors:
        raise AssertionError("\n".join(errors))
    return results


# ------------------------------------------------------------- rank bodies

def _nets(backend=None, recurrent=False):
    from repro_torch.core import layer, network
    kw = {} if backend is None else dict(backend=backend)
    l1 = layer.TNNLayer(**L1, recurrent=recurrent, **kw)
    l2 = layer.TNNLayer(**L2, recurrent=recurrent, **kw)
    odd = layer.TNNLayer(**ODD, recurrent=recurrent, **kw)
    return network.make_network([l1, l2]), network.make_network([odd])


def _blocks(params, net, mesh):
    import torch
    from repro_torch.core import network
    from repro_torch.sharding import specs
    return tuple(specs.shard_of(torch.from_numpy(p), spec, mesh)
                 for p, spec in zip(params, network.param_shardings(net,
                                                                    mesh)))


def _np(t):
    return t.detach().cpu().numpy().copy()


def core_suite(mesh, params, podd, rparams, rpodd) -> Dict[str, Any]:
    """Layers, networks, the pipelined and recurrent forwards,
    ``layer_step``, ``init_network``, the eager bank, the policy, the
    wrappers' raises and ``tnn_mesh``'s validation, on one mesh."""
    import torch
    from repro_torch.core import layer, network, neuron, policy
    from repro_torch.kernels import rnl_shard
    from repro_torch.sharding import specs

    out: Dict[str, Any] = {}
    # ---- layer_forward and network.forward, every engine, both nets
    for backend in BACKENDS:
        for tag, (net, ps) in (("net", (_nets(backend)[0], params)),
                               ("odd", (_nets(backend)[1], podd))):
            blocks = _blocks(ps, net, mesh)
            for i, vol in enumerate(draws_for(net.n_inputs)):
                x = torch.from_numpy(vol)
                res = network.forward(blocks, x, net, mesh=mesh)
                out[f"fwd/{backend}/{tag}/{i}/out"] = _np(res.out)
                for li, w in enumerate(res.winners):
                    out[f"fwd/{backend}/{tag}/{i}/win{li}"] = _np(w)
                lo, lw = layer.layer_forward(blocks[0], x, net.layers[0],
                                             mesh=mesh)
                out[f"layer/{backend}/{tag}/{i}/out"] = _np(lo)
                out[f"layer/{backend}/{tag}/{i}/win"] = _np(lw)
    # ---- densities measured on the whole batch
    net, _ = _nets("closed_form")
    vol = torch.from_numpy(draws_for(net.n_inputs)[0])
    out["densities"] = np.asarray(network.forward(
        _blocks(params, net, mesh), vol, net, with_densities=True,
        mesh=mesh).densities)
    # ---- pipelined, ragged splits and M > B included
    for backend in ("closed_form", "fused", "fused_compact"):
        net, _ = _nets(backend)
        blocks = _blocks(params, net, mesh)
        vol = torch.from_numpy(draws_for(net.n_inputs)[0])
        for m in (2, 3, 8, 20):
            res = network.forward(blocks, vol, net, microbatches=m,
                                  mesh=mesh)
            out[f"pipe/{backend}/{m}/out"] = _np(res.out)
            for li, w in enumerate(res.winners):
                out[f"pipe/{backend}/{m}/win{li}"] = _np(w)
    # ---- recurrent: four cycles, barriered and pipelined
    rnet, rodd = _nets("fused", recurrent=True)
    for tag, net, ps in (("net", rnet, rparams), ("odd", rodd, rpodd)):
        blocks = _blocks(ps, net, mesh)
        seq = draws_for(net.n_inputs)[:3] + [draws_for(net.n_inputs)[3]]
        for m in (1, 3):
            carry = None
            for t, vol in enumerate(seq):
                res = network.forward(blocks, torch.from_numpy(vol), net,
                                      carry=carry, microbatches=m,
                                      mesh=mesh)
                out[f"rec/{tag}/{m}/{t}"] = _np(res.out)
                carry = res.carry
            for li, c in enumerate(carry):
                out[f"rec/{tag}/{m}/carry{li}"] = _np(c)
    # ---- layer_step: the expectation rule, a seeded stochastic rule,
    # and the same on one device in this process
    for tag, net, ps in (("net", _nets("closed_form")[0], params),
                         ("odd", _nets("closed_form")[1], podd)):
        lc = net.layers[0]
        w = torch.round(torch.from_numpy(ps[0]))
        blk = _blocks((w.numpy(),), network.make_network([lc]), mesh)[0]
        vol = torch.from_numpy(draws_for(net.n_inputs)[0])
        for rule in ("mean", "seeded"):
            key = (None if rule == "mean"
                   else torch.Generator().manual_seed(11))
            new_w, o, win = layer.layer_step(blk, vol, lc, key, mesh=mesh)
            whole = specs.gather(new_w, specs.tnn_param_pspec(
                mesh, lc.n_columns), mesh)
            key1 = (None if rule == "mean"
                    else torch.Generator().manual_seed(11))
            w1, o1, win1 = layer.layer_step(w, vol, lc, key1)
            out[f"step/{tag}/{rule}/w"] = _np(whole)
            out[f"step/{tag}/{rule}/w_one"] = _np(w1)
            out[f"step/{tag}/{rule}/out"] = _np(o)
            out[f"step/{tag}/{rule}/win"] = _np(win)
            out[f"step/{tag}/{rule}/out_one"] = _np(o1)
            out[f"step/{tag}/{rule}/block"] = list(new_w.shape)
    # network.step over the stack, recurrent, whole draws handed in
    net, _ = _nets("fused", recurrent=True)
    vol = torch.from_numpy(draws_for(net.n_inputs)[0])
    g = torch.Generator().manual_seed(3)
    draws = [torch.rand((lc.n_columns, 8, lc.n_neurons, lc.rf_total),
                        generator=g) for lc in net.layers]
    res = network.step(_blocks(rparams, net, mesh), vol, net, draws=draws,
                       mesh=mesh)
    one = network.step(tuple(torch.from_numpy(p) for p in rparams), vol,
                       net, draws=draws)
    for li, (p, spec) in enumerate(zip(res.params, network.param_shardings(
            net, mesh))):
        out[f"nstep/w{li}"] = _np(specs.gather(p, spec, mesh))
        out[f"nstep/w{li}_one"] = _np(one.params[li])
    out["nstep/out"] = _np(res.out)
    out["nstep/out_one"] = _np(one.out)
    # ---- init_network(mesh=): the unsharded init, block by block
    for tag, net in zip(("net", "odd"), _nets()):
        whole = network.init_network(torch.Generator().manual_seed(0), net,
                                     device="cpu")
        blocks = network.init_network(torch.Generator().manual_seed(0), net,
                                      mesh=mesh)
        out[f"init/{tag}/specs"] = network.param_shardings(net, mesh)
        out[f"init/{tag}/blocks"] = [list(b.shape) for b in blocks]
        out[f"init/{tag}/equal"] = all(
            torch.equal(specs.gather(b, spec, mesh), w) for b, w, spec in
            zip(blocks, whole, network.param_shardings(net, mesh)))
    # ---- the eager bank: this rank's block through the fused engines
    net, odd = _nets()
    for tag, lc, ps in (("net", net.layers[0], params),
                        ("odd", odd.layers[0], podd)):
        vol = torch.from_numpy(draws_for(lc.n_inputs)[0])
        rf = layer._gather_rf(vol, lc)                  # (C, B, rf) whole
        w = torch.round(torch.from_numpy(ps[0])).to(torch.int32)
        spec = specs.tnn_data_pspec(mesh, lc.n_columns, 8)
        t_blk = specs.shard_of(rf, spec, mesh)
        w_blk = specs.shard_of(w, specs.tnn_param_pspec(mesh, lc.n_columns),
                               mesh)
        for backend in ("fused", "fused_compact", "auto"):
            got = neuron.fire_times_bank(t_blk, w_blk, lc.neuron_config(),
                                         backend=backend, mesh=mesh,
                                         shape=tuple(rf.shape))
            out[f"bank/{tag}/{backend}"] = _np(specs.gather(got, spec, mesh))
        # a block that is not this rank's raises
        if spec[0] is not None:
            try:
                neuron.fire_times_bank(rf, w, lc.neuron_config(),
                                       backend="fused", mesh=mesh,
                                       shape=tuple(rf.shape))
                out[f"bank/{tag}/wrong_block"] = "no raise"
            except ValueError:
                out[f"bank/{tag}/wrong_block"] = "raised"
    # ---- the policy's capability model on this mesh
    pol = policy.default_policy()
    out["policy"] = dict(
        active=policy.mesh_active(mesh),
        fused8=pol.resolve("fused", column_counts=8, mesh=mesh).engine,
        compact84=pol.resolve("fused_compact", column_counts=(8, 4),
                              mesh=mesh).engine,
        unknown=pol.resolve("fused", mesh=mesh).engine,
        fused5=pol.resolve("fused", column_counts=5, mesh=mesh).engine,
        compact5=pol.resolve("fused_compact", column_counts=5,
                             mesh=mesh).engine,
        requested5=pol.resolve("fused", column_counts=5,
                               mesh=mesh).requested,
        auto8_cpu=pol.resolve("auto", column_counts=8, mesh=mesh).requested,
        auto8_cuda=pol.resolve("auto", column_counts=8, mesh=mesh,
                               device="cuda").engine,
        auto5_cuda_density=policy.density_policy().resolve(
            "auto", column_counts=5, density=0.1, mesh=mesh,
            device="cuda").engine,
        fused5_cuda=pol.resolve("fused", column_counts=5, mesh=mesh,
                                device="cuda").engine)
    # ---- the wrappers' raises
    t = torch.zeros((5, 8, 4), dtype=torch.int32)
    w = torch.zeros((5, 3, 4), dtype=torch.int32)
    raises = {}
    for name, kw in (("no_mesh", dict(mesh=None)),
                     ("not_tiling", dict(mesh=mesh))):
        try:
            rnl_shard.rnl_fire_times_layer_sharded(t, w, t_steps=12,
                                                   threshold=5, **kw)
            raises[name] = None
        except ValueError as e:
            raises[name] = str(e)
    out["raises"] = raises
    # ---- tnn_mesh's validation at this world size
    errors = {}
    for bad in (dict(n_data=3), dict(n_column=16, n_data=1),
                dict(n_column=0, n_data=1), dict(n_column=4, n_data=0),
                dict(n_column=-2, n_data=1)):
        try:
            specs.tnn_mesh(**bad, device_type="cpu")
            errors[str(bad)] = None
        except ValueError as e:
            errors[str(bad)] = str(e)
    out["tnn_mesh_errors"] = errors
    out["tnn_mesh_default"] = tuple(specs.tnn_mesh(
        device_type="cpu").shape)
    out["tnn_mesh_2_2"] = tuple(specs.tnn_mesh(2, 2,
                                               device_type="cpu").shape)
    # ---- gathers put blocks back in coordinate order, also on a mesh
    # whose ranks are laid out in reverse (coordinate order != rank order)
    whole = torch.arange(8 * 6 * 2, dtype=torch.int32).reshape(8, 6, 2)
    shape = tuple(mesh.shape)
    import torch.distributed as dist
    rev = specs.tnn_mesh(shape[1], shape[0], device_type="cpu",
                         devices=list(reversed(range(dist.get_world_size()))))
    for tag, m in (("mesh", mesh), ("reversed", rev)):
        spec = ("column", "data", None)
        out[f"gather/{tag}"] = bool(torch.equal(
            specs.gather(specs.shard_of(whole, spec, m), spec, m), whole))
        spec = (("data", "column"), None, None)
        out[f"gather/{tag}/both_axes"] = bool(torch.equal(
            specs.gather(specs.shard_of(whole, spec, m), spec, m), whole))
    out["coordinate"] = list(mesh.get_coordinate())
    return out


def engine_suite(mesh, params, podd, rparams, streams, snap_dir
                 ) -> Dict[str, Any]:
    """``TNNEngine(mesh=)``: serving at n_slots = 3, the capability
    model's stats rows, the pipelined and recurrent engines, learning
    while serving against the single-device engine, and ``serve_resilient``
    through an injected failure, on one mesh."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import network
    from repro_torch.serve import tnn_engine
    from repro_torch.sharding import specs
    from repro_torch.train import fault_tolerance as FT

    net, odd = _nets()
    rnet, _ = _nets(recurrent=True)
    tp = tuple(torch.from_numpy(p) for p in params)
    out: Dict[str, Any] = {}

    def engine(ps, n, **kw):
        mk = dict(kw)
        device = mk.pop("device", None)
        return tnn_engine.TNNEngine(ps, n, tnn_engine.TNNServeConfig(**mk),
                                    device=device, mesh=mesh)

    # ---- serving, auto policy re-resolving each step, 3 slots
    eng = engine(tp, net, n_slots=3)
    out["serve/auto"] = eng.serve(streams)
    out["serve/auto/stats"] = {k: v for k, v in eng.stats().items()
                               if not k.startswith(("run_s", "volleys_per",
                                                    "latency"))}
    out["serve/auto/block"] = [list(p.shape) for p in eng.params]
    # the engine takes whole stacks (the same on every rank) and keeps its
    # blocks of them; blocks (init_network(mesh=)) are refused
    whole = network.init_network(torch.Generator().manual_seed(0), net,
                                 device="cpu")
    eng = engine(whole, net, n_slots=3)
    ref = tnn_engine.TNNEngine(whole, net,
                               tnn_engine.TNNServeConfig(n_slots=3),
                               device="cpu")
    out["serve/init_whole_equal"] = all(
        np.array_equal(a, b) for a, b in zip(eng.serve(streams[:2]),
                                             ref.serve(streams[:2])))
    out["serve/init_whole_blocks_kept"] = all(
        torch.equal(a, b) for a, b in zip(
            eng.params, network.init_network(
                torch.Generator().manual_seed(0), net, mesh=mesh)))
    try:
        engine(network.init_network(torch.Generator().manual_seed(0), net,
                                    mesh=mesh), net, n_slots=3)
        out["serve/blocks_refused"] = "no raise"
    except ValueError:
        out["serve/blocks_refused"] = "raised"
    # ---- the capability model's stats rows
    for tag, n, ps in (("net", net, tp),
                       ("odd", odd, tuple(torch.from_numpy(p)
                                          for p in podd))):
        vol = streams[0] if tag == "net" else None
        eng = engine(ps, n, n_slots=2, backend="fused")
        src = [vol[:2]] if vol is not None else [
            np.asarray(draws_for(n.n_inputs)[0][:2])]
        out[f"cap/{tag}"] = eng.serve(src)
        out[f"cap/{tag}/input"] = src
        out[f"cap/{tag}/stats"] = {k: v for k, v in eng.stats().items()
                                   if k.startswith("steps_")}
    # ---- pipelined and recurrent engines
    eng = engine(tp, net, n_slots=3, pipeline_microbatches=3,
                 backend="fused_compact")
    out["serve/pipelined"] = eng.serve(streams[:3])
    out["serve/pipelined/stages"] = eng.stats()["pipeline_microbatches"]
    eng = engine(tuple(torch.from_numpy(p) for p in rparams), rnet,
                 n_slots=3)
    out["serve/recurrent"] = eng.serve(streams)
    # ---- learning while serving against the one-device engine
    for rule, seed in (("mean", None), ("seeded", 5)):
        eng = engine(tp, net, n_slots=2, backend="closed_form", learn=True,
                     stdp_seed=seed)
        res = eng.serve(streams)
        one = tnn_engine.TNNEngine(
            tp, net, tnn_engine.TNNServeConfig(
                n_slots=2, backend="closed_form", learn=True,
                stdp_seed=seed), device="cpu")
        res_one = one.serve(streams)
        out[f"learn/{rule}"] = res
        out[f"learn/{rule}/outputs_equal_one"] = all(
            np.array_equal(a, b) for a, b in zip(res, res_one))
        out[f"learn/{rule}/w"] = [_np(p) for p in eng.whole_params()]
        out[f"learn/{rule}/w_one"] = [_np(p) for p in one.params]
        out[f"learn/{rule}/updates"] = (eng.n_stdp_updates, eng.n_steps)
        out[f"learn/{rule}/block"] = [list(p.shape) for p in eng.params]
        out[f"learn/{rule}/drift"] = [eng.stats()[f"weight_drift_l{i}"]
                                      for i in range(2)]
    # ---- serve_resilient through an injected failure, every rank alike
    def boom_at(step, host):
        fired = [False]

        def boom(step_id):
            if step_id >= step and not fired[0]:
                fired[0] = True
                raise FT.WorkerFailure(host, "(injected)")
        return boom

    d = os.path.join(snap_dir, "off")
    eng = engine(tp, net, n_slots=2, backend="closed_form",
                 checkpoint_dir=d, checkpoint_every=2, checkpoint_keep=100,
                 checkpoint_async=False)
    res, report = tnn_engine.serve_resilient(eng, streams,
                                             failure_injector=boom_at(3, 5))
    out["resilient/off"] = res
    out["resilient/off/report"] = report
    out["resilient/off/restores"] = eng.n_restores
    out["resilient/off/snapshots"] = eng.n_snapshots
    # learning on: the resumed run equals the replay from its snapshot
    d2 = os.path.join(snap_dir, "learn")
    eng = engine(tp, net, n_slots=2, backend="closed_form", learn=True,
                 checkpoint_dir=d2, checkpoint_every=2, checkpoint_keep=100,
                 checkpoint_async=True)
    res, report = tnn_engine.serve_resilient(eng, streams,
                                             failure_injector=boom_at(3, 6))
    s = report["restored_steps"][0]
    from repro_torch.train import checkpoint as CKPT
    snap = CKPT.restore_checkpoint(
        d2, {"params": tuple(tp), "counters": np.zeros(2, np.int32)}, s)
    replay = engine(snap["params"], net, n_slots=2, backend="closed_form",
                    learn=True)
    replay.step_id = s
    replay.n_stdp_updates = int(snap["counters"][1])
    replay.serve([streams[i] for i in report["resubmitted"][0]])
    out["resilient/learn/report"] = report
    out["resilient/learn/w"] = [_np(p) for p in eng.whole_params()]
    out["resilient/learn/w_replay"] = [_np(p)
                                       for p in replay.whole_params()]
    out["resilient/learn/block"] = [list(p.shape) for p in eng.params]
    # the snapshot directory holds one writer's files
    out["snapshot_hosts"] = sorted(os.listdir(os.path.join(
        d, f"step_{2:08d}")))
    # a device that disagrees with the mesh's raises
    try:
        tnn_engine.TNNEngine(tp, net, tnn_engine.TNNServeConfig(n_slots=2),
                             device="meta", mesh=mesh)
        out["device_disagrees"] = "no raise"
    except ValueError:
        out["device_disagrees"] = "raised"
    out["mesh"] = tuple(mesh.shape)
    dist.barrier()
    return out


@dataclasses.dataclass
class MeshShape:
    """What the sharding rules read of a mesh: its dim names and sizes.
    Stands in for a ``DeviceMesh`` where no rank is needed."""

    dims: Dict[str, int]

    @property
    def mesh_dim_names(self):
        return tuple(self.dims)

    @property
    def shape(self):
        return tuple(self.dims.values())
