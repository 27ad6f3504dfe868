"""LM training launcher, single device.

Composes the stack: arch config -> train step -> deterministic data
pipeline -> checkpoint/restart -> heartbeat monitor, on one device
(``--device``, ``cuda`` by default; ``--smoke`` takes the reduced config
and a small batch, which the CPU runs). A run restarted with the same
flags resumes from the latest checkpoint under ``--ckpt-dir`` and takes
the steps the uninterrupted run would have taken.

``--opt`` applies the reference's layout transform
(:func:`repro_torch.launch.dryrun.apply_opt`); on one device only its MoE
settings change what runs. The reference's mesh branch (more than one
process) comes with the multi-GPU slice of the port and raises here.

Usage:
  python -m repro_torch.launch.train --arch internlm2-1.8b --smoke \
      --steps 50 --device cpu
  python -m repro_torch.launch.train --arch mamba2-780m --steps 100 \
      --global-batch 8 --grad-accum 4 --compress
  python -m repro_torch.launch.train --arch deepseek-v2-lite-16b --smoke \
      --opt --steps 1 --device cpu
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
from repro_torch.kernels.common import resolve_device
from repro_torch.launch.dryrun import apply_opt
from repro_torch.optim import grad_compression as GC
from repro_torch.optim.optimizers import AdamWConfig
from repro_torch.train import checkpoint as CK
from repro_torch.train import fault_tolerance as FT
from repro_torch.train import train_loop as TL

MULTI_GPU = ("the multi-GPU slice of the port (ROADMAP, Queue 1: sharding "
             "specs and the mesh)")


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


def _world_size() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


Hook = Callable[[int, TL.TrainState, Dict[str, torch.Tensor]], None]
Data = Union[DP.SyntheticLM, DP.MemmapCorpus]


def setup(args: argparse.Namespace
          ) -> Tuple[ModelConfig, TL.TrainConfig, Data]:
    """The model config, train config and data stream that ``args`` (the
    launcher's parsed flags) ask for."""
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
    step and its checkpoint. Returns the final state, the start step, and
    each step's loss and seconds (host clock, ended by reading the
    loss)."""
    args = parser().parse_args(argv)
    if _world_size() > 1:
        raise NotImplementedError(f"training over {_world_size()} processes "
                                  f"comes with {MULTI_GPU}")
    dev = resolve_device(args.device)
    cfg, tcfg, data = setup(args)
    host = 0
    print(f"[train] {cfg.name}: {cfg.param_count() / 1e6:.1f}M params, "
          f"seq {data.cfg.seq_len}, global batch {data.cfg.global_batch}, "
          f"device {dev}", flush=True)

    gen = torch.Generator(device=dev).manual_seed(0)
    state = TL.init_train_state(gen, cfg, tcfg, device=dev)
    step_fn = TL.make_train_step(cfg, tcfg)

    mgr = CK.CheckpointManager(args.ckpt_dir, keep=3, every=args.ckpt_every,
                               async_save=True)
    state, start = mgr.restore_latest(state)
    if start:
        print(f"[train] resumed from step {start}", flush=True)
    monitor = FT.HeartbeatMonitor(n_hosts=1)

    losses, step_s = [], []
    t0 = time.time()
    try:
        for i in range(start, args.steps):
            ts = time.time()
            state, metrics = step_fn(state, data.batch(i))
            losses.append(float(metrics["loss"]))
            step_s.append(time.time() - ts)
            monitor.beat(host, step_s[-1])
            mgr.maybe_save(i + 1, state)
            for hook in hooks:
                hook(i, state, metrics)
            if (i + 1) % 10 == 0:
                stragglers = monitor.stragglers()
                extra = f" STRAGGLERS={stragglers}" if stragglers else ""
                print(f"[train] step {i + 1:5d} loss {losses[-1]:.4f} "
                      f"lr {float(metrics['lr']):.2e}{extra}", flush=True)
    finally:
        mgr.wait()
    dt = time.time() - t0
    if losses:
        print(f"[train] {len(losses)} steps in {dt:.1f}s; "
              f"loss {np.mean(losses[:5]):.3f} -> "
              f"{np.mean(losses[-5:]):.3f}", flush=True)
    return dict(state=state, start=start, losses=losses, step_s=step_s)


if __name__ == "__main__":
    main()
