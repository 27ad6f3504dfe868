"""LM training launcher, on one device or across GPUs.

Composes the stack: arch config -> train step -> deterministic data
pipeline -> checkpoint/restart -> heartbeat monitor (``--device``,
``cuda`` by default; ``--smoke`` takes the reduced config and a small
batch, which the CPU runs). A run restarted with the same flags resumes
from the latest checkpoint under ``--ckpt-dir`` and takes the steps the
uninterrupted run would have taken.

One process trains on one device. Started by ``torchrun`` (or inside an
initialised process group) with more than one process, every rank runs
this same loop on a ``("data", "model")`` mesh
(:func:`repro_torch.sharding.specs.lm_mesh`) of ``model_par = min(16,
world)`` by ``data_par = world // model_par`` ranks, as the reference's
mesh branch does: each rank holds its blocks of the state and runs the
mesh step (:func:`repro_torch.train.train_loop.make_train_step` with
``mesh=``). On one device and on a mesh the step donates its state
(``donate=True``), as the reference jits it with ``donate_argnums``.
Every rank reads the whole global batch (the stream is deterministic)
and the step takes the rank's rows of it. The blocks are
made as such: each parameter is cut as soon as it is drawn, the moments
and the error buffer are made as blocks. Each checkpoint is
gathered leaf by leaf to the host of the rank at the mesh origin, which
writes it in the single-device format; every rank restores it by cutting
each leaf to its block on the host, so a checkpoint crosses between one
device and a mesh both ways. NCCL joins ``cuda`` ranks (each on
``LOCAL_RANK``'s GPU), gloo ``cpu`` ones.

Up to 16 processes the mesh is ``(1, world)``, and the step splits its
work over ``model`` as the reference's specs lay the parameters out
(:func:`repro_torch.models.transformer.tp_plan`): the vocabulary, the
attention and Mamba2 heads and the MLP's d_ff (tensor parallelism), the
residual stream's sequence under ``act_sp`` (sequence parallelism), the
experts under ``catwalk_ep``; under ``batch_over_model`` (mamba2 and
zamba2 with ``--opt``) the rows take the ``model`` axis instead, and
each rank gathers the parameters for its rows.

``--opt`` applies the reference's layout transform
(:func:`repro_torch.launch.dryrun.apply_opt`): under a mesh
``catwalk_ep`` runs the expert-parallel MoE layer, ``act_sp`` splits the
sequence between the layers and ``batch_over_model`` splits the rows
over ``model`` too.

Usage:
  python -m repro_torch.launch.train --arch internlm2-1.8b --smoke \
      --steps 50 --device cpu
  python -m repro_torch.launch.train --arch mamba2-780m --steps 100 \
      --global-batch 8 --grad-accum 4 --compress
  torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch deepseek-v2-lite-16b --smoke --opt --steps 10
"""

from __future__ import annotations

import argparse
import pathlib
import tempfile
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.data import pipeline as DP
from repro_torch.kernels.common import env_int, resolve_device
from repro_torch.launch.dryrun import apply_opt
from repro_torch.optim import grad_compression as GC
from repro_torch.optim.optimizers import AdamWConfig
from repro_torch.sharding import specs as SH
from repro_torch.train import checkpoint as CK
from repro_torch.train import fault_tolerance as FT
from repro_torch.train import train_loop as TL

def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=list(ARCH_IDS), required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config + small batch (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=0)
    ap.add_argument("--global-batch", type=int, default=0)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--compress", action="store_true",
                    help="Catwalk top-k gradient compression (rho 0.01)")
    ap.add_argument("--opt", action="store_true",
                    help="hillclimbed layout (see dryrun.apply_opt)")
    ap.add_argument("--ckpt-dir", default=str(
        pathlib.Path(tempfile.gettempdir()) / "repro_torch_launch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--data", default="synthetic",
                    help="'synthetic' or a path to a uint16 token memmap")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "versions of the kernels)")
    return ap


def _process_group(dev: torch.device) -> bool:
    """Join the process group ``torchrun`` describes (``WORLD_SIZE`` > 1 in
    the environment) unless one is initialised already: NCCL for a
    ``cuda`` device, gloo otherwise. Returns whether it was started
    here."""
    dist = torch.distributed
    if dist.is_initialized() or env_int("WORLD_SIZE", 1) <= 1:
        return False
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    return True


def _world_size() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def mesh_shape(world: int) -> Tuple[int, int]:
    """(data_par, model_par) of the launcher's mesh over ``world`` ranks:
    the reference's ``model_par = min(16, world)``."""
    model_par = min(16, world)
    if world % model_par:
        raise ValueError(f"{world} processes do not fill a mesh of "
                         f"{model_par}-way model parallelism")
    return world // model_par, model_par


Hook = Callable[[int, TL.TrainState, Dict[str, torch.Tensor]], None]
Data = Union[DP.SyntheticLM, DP.MemmapCorpus]


def setup(args: argparse.Namespace
          ) -> Tuple[ModelConfig, TL.TrainConfig, Data]:
    """The model config, train config and data stream that ``args`` (the
    launcher's parsed flags) ask for; the stream reads the whole global
    batch."""
    cfg = get_config(args.arch + ("-smoke" if args.smoke else ""))
    if args.opt:
        cfg = apply_opt(cfg)
    tcfg = TL.TrainConfig(
        optimizer=AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps),
                              total_steps=args.steps),
        grad_accum=args.grad_accum,
        compression=GC.CompressionConfig(rho=0.01) if args.compress
        else None)
    dcfg = DP.DataConfig(seq_len=args.seq_len or (128 if args.smoke
                                                  else 4096),
                         global_batch=args.global_batch or (
                             8 if args.smoke else 256),
                         vocab_size=cfg.vocab_size)
    data = (DP.SyntheticLM(dcfg) if args.data == "synthetic"
            else DP.MemmapCorpus(args.data, dcfg))
    return cfg, tcfg, data


def main(argv: Optional[Sequence[str]] = None, *,
         hooks: Sequence[Hook] = ()) -> Dict[str, Any]:
    """Run the launcher with ``argv`` (``None``: the command line).
    ``hooks`` are called as ``hook(step_index, state, metrics)`` after each
    step and its checkpoint; the step donates its state (``make_train_step(
    ..., donate=True)``), so a hook that keeps the state past its call
    copies it first. Returns the final state (this rank's blocks
    under a mesh), the start step, each step's loss and seconds (host
    clock, ended by reading the loss), and the mesh (``None`` on one
    device)."""
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    local = env_int("LOCAL_RANK")
    if dev.type == "cuda" and local is not None:
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
    started = _process_group(dev)
    try:
        return _run(args, dev, hooks)
    finally:
        if started:
            torch.distributed.destroy_process_group()


def _run(args: argparse.Namespace, dev: torch.device,
         hooks: Sequence[Hook]) -> Dict[str, Any]:
    world = _world_size()
    mesh, rank = None, 0
    if world > 1:
        data_par, model_par = mesh_shape(world)
        mesh = SH.lm_mesh(model_par, data_par, device_type=dev.type)
        dev = SH.mesh_device(mesh, dev)
        rank = torch.distributed.get_rank()
    origin = mesh is None or SH.is_origin(mesh)
    cfg, tcfg, data = setup(args)
    if origin:
        print(f"[train] {cfg.name}: {cfg.param_count() / 1e6:.1f}M params, "
              f"seq {data.cfg.seq_len}, global batch "
              f"{data.cfg.global_batch}, device {dev}"
              + (f", mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}"
                 if mesh is not None else ""), flush=True)

    gen = torch.Generator(device=dev).manual_seed(0)
    state = TL.init_train_state(gen, cfg, tcfg, device=dev, mesh=mesh)
    # the reference jits the step with donate_argnums=(0,): the state is
    # updated in place and held once
    step_fn = TL.make_train_step(cfg, tcfg, mesh=mesh, donate=True)

    mgr = CK.CheckpointManager(args.ckpt_dir, keep=3, every=args.ckpt_every,
                               async_save=True)
    cut = None
    if mesh is not None:
        st_specs = TL.state_pspecs(cfg, tcfg, mesh)

        def cut(key, whole):
            return SH.shard_of(whole, SH.param_pspec(
                key, whole, mesh, cfg.batch_over_model), mesh)
        # the origin's last save is published before any rank reads
        SH.barrier(mesh)
    state, start = mgr.restore_latest(state, cut=cut)
    if start and origin:
        print(f"[train] resumed from step {start}", flush=True)
    monitor = FT.HeartbeatMonitor(n_hosts=world)

    losses, step_s = [], []
    t0 = time.perf_counter()
    try:
        for i in range(start, args.steps):
            ts = time.perf_counter()
            state, metrics = step_fn(state, data.batch(i))
            losses.append(float(metrics["loss"]))
            step_s.append(time.perf_counter() - ts)
            monitor.beat(rank, step_s[-1])
            if mesh is None:
                mgr.maybe_save(i + 1, state)
            elif (i + 1) % args.ckpt_every == 0:
                whole = SH.gather_tree(state, st_specs, mesh, to="cpu")
                if origin:
                    mgr.maybe_save(i + 1, whole)
                del whole
            for hook in hooks:
                hook(i, state, metrics)
            if (i + 1) % 10 == 0 and origin:
                stragglers = monitor.stragglers()
                extra = f" STRAGGLERS={stragglers}" if stragglers else ""
                print(f"[train] step {i + 1:5d} loss {losses[-1]:.4f} "
                      f"lr {float(metrics['lr']):.2e}{extra}", flush=True)
    finally:
        mgr.wait()
    dt = time.perf_counter() - t0
    if losses and origin:
        print(f"[train] {len(losses)} steps in {dt:.1f}s; "
              f"loss {np.mean(losses[:5]):.3f} -> "
              f"{np.mean(losses[-5:]):.3f}", flush=True)
    return dict(state=state, start=start, losses=losses, step_s=step_s,
                mesh=mesh)


if __name__ == "__main__":
    main()
