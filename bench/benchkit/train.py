"""The ``train`` mix: the launcher's training step, steps back to back.

Set-up builds one object, the step the launcher builds
(``repro_torch.launch.train.setup``, then
``train_loop.make_train_step(cfg, tcfg, donate=True)``) with its state
(the benchmark's weights from the seed, zero AdamW moments), and drives
it through the mix's ``checked_steps`` first steps (which also warm up
every shape): after the first, the clipped gradient each leaf gave AdamW
is read back from its first moment (m_1 = (1 - beta1) g); after the
last, each leaf's change from the weights it started from. The same
object then runs the window. The plain reference follows the checked
steps from the same weights and batches once the window has closed.
"""

from __future__ import annotations

import statistics
import sys
import time
import traceback
from typing import Any, Dict, List

import torch

from benchkit import inputs, program
from references import plain


def launcher_args(cell) -> List[str]:
    """The launcher's flags for the cell's configuration and mix."""
    mix, arch = cell.mix, cell.config["program_arch"]
    # the launcher runs a reduced ("-smoke") config under --smoke
    smoke = arch.endswith("-smoke")
    return ["--arch", arch[:-len("-smoke")] if smoke else arch,
            *(["--smoke"] if smoke else []),
            "--steps", str(mix["launcher_steps"]),
            "--seq-len", str(mix["seq_len"]),
            "--global-batch", str(mix["global_batch"]),
            "--grad-accum", str(mix["grad_accum"]),
            "--lr", str(mix["optimizer"]["lr"]), "--device", "cuda"]


def build(cell):
    """(model config, train config) as the launcher sets them up for the
    cell, each held to the configuration file and the mix; raises
    ``ValueError`` where the program would run something else."""
    from repro_torch.launch import train as launcher
    args = launcher.parser().parse_args(launcher_args(cell))
    cfg, tcfg, _ = launcher.setup(args)
    program.check_fields(cfg, cell.config)
    opt = tcfg.optimizer
    wrong = {k: (v, getattr(opt, k)) for k, v in cell.mix["optimizer"].items()
             if getattr(opt, k) != v}
    if wrong or tcfg.compressing or opt.moments_dtype != "float32" \
            or tcfg.grad_accum != cell.mix["grad_accum"]:
        raise ValueError(f"the launcher's step differs from the mix: {wrong}")
    return cfg, tcfg


def batch(cell, seed: int, index: int, dev) -> Dict[str, torch.Tensor]:
    mix = cell.mix
    tokens, labels = inputs.token_batch(seed, index, mix["global_batch"],
                                        mix["seq_len"],
                                        cell.config["vocab_size"], dev)
    return {"tokens": tokens, "labels": labels}


def setup(cell, seed: int, dev, step_of=None) -> Dict[str, Any]:
    """The step, its state after the checked steps, and what they left to
    compare (``losses``, ``first_grad``, ``update``: per-leaf norms).
    ``step_of(step_fn)``: wraps the step (a planted fault's hook)."""
    from repro_torch.optim import optimizers as O
    from repro_torch.train import train_loop as TL
    cfg, tcfg = build(cell)
    ref = cell.reference
    params = ref.init(inputs.generator(dev, seed, "weights"), cell.config,
                      dev)
    # the weights as they start, on the host: the card holds only what the
    # launcher's run would, so the window starts as its next step would
    start = [t.to("cpu", copy=True) for _, t in plain.leaves(params)]
    state = TL.TrainState(params, O.init_adamw(params, tcfg.optimizer), None,
                          torch.zeros((), dtype=torch.int32, device=dev))
    del params
    step_fn = TL.make_train_step(cfg, tcfg, donate=True)
    if step_of is not None:
        step_fn = step_of(step_fn)
    beta1 = tcfg.optimizer.beta1
    losses: List[float] = []
    first_grad: Dict[str, float] = {}
    for i in range(cell.mix["checked_steps"]):
        state, metrics = step_fn(state, batch(cell, seed, i, dev))
        losses.append(float(metrics["loss"]))
        if i == 0:
            first_grad = plain.leaf_norms(state.opt.m, scale=1 / (1 - beta1))
    update = plain.leaf_norms(state.params, minus=start)
    del start, metrics
    return dict(step_fn=step_fn, state=state,
                records=dict(losses=losses, first_grad=first_grad,
                             update=update))


def reference_records(cell, seed: int, dev, precision: str = "f32"
                      ) -> Dict[str, Any]:
    """The plain reference's records of the checked steps, from the same
    weights and batches, in ``precision`` (``"fp8"``: the control)."""
    ref, config, mix = cell.reference, cell.config, cell.mix
    with plain.float32_products():
        params = ref.init(inputs.generator(dev, seed, "weights"), config,
                          dev)
        batches = [tuple(batch(cell, seed, i, dev).values())
                   for i in range(mix["checked_steps"])]
        out = plain.train_steps(
            lambda tree, t, l, prec: ref.loss(tree, t, l, config, prec),
            params, batches, mix["optimizer"], mix["grad_accum"],
            plain.Precision(precision))
        start = ref.init(inputs.generator(dev, seed, "weights"), config,
                         dev)
        out["update"] = plain.leaf_norms(
            params, minus=[t for _, t in plain.leaves(start)])
    return out


def _gaps(got: Dict[str, float], want: Dict[str, float], keep
          ) -> List[float]:
    """Each kept leaf's gap between two norms, over the larger of the
    reference's norm of the leaf and its median kept leaf's."""
    names = [n for n in want if keep(n)]
    med = statistics.median(want[n] for n in names)
    return [abs(got[n] - want[n]) / max(want[n], med) for n in names]


def readings(got: Dict[str, Any], want: Dict[str, Any]) -> Dict[str, float]:
    """What the program's records (``got``) read against the reference's
    (``want``): ``loss_gap``, the largest relative gap of a checked step's
    loss; ``grad_gap``, the worst leaf's gap of the first clipped
    gradient's norm (:func:`_gaps`; ``grad_gap_median``: the median
    leaf's); ``update_gap``, the worst leaf's gap of the change's norm
    after the checked steps, over the leaves whose reference gradient is
    at least a thousandth of the median leaf's (the others move by
    rounding alone)."""
    g = want["first_grad"]
    floor = 1e-3 * statistics.median(g.values())
    grads = _gaps(got["first_grad"], g, lambda n: True)
    return dict(
        loss_gap=max(abs(a - b) / abs(b)
                     for a, b in zip(got["losses"], want["losses"])),
        grad_gap=max(grads), grad_gap_median=statistics.median(grads),
        update_gap=max(_gaps(got["update"], want["update"],
                             lambda n: g[n] >= floor)))


def run(cell, seed: int, seconds: float, tracer, dev,
        step_of=None) -> Dict[str, Any]:
    """Set-up, the window, then the reference; see the module docstring."""
    built = setup(cell, seed, dev, step_of=step_of)
    state, step_fn = built.pop("state"), built["step_fn"]
    mix = cell.mix
    tokens_per_step = mix["global_batch"] * mix["seq_len"]
    program.sync(dev)
    setup_peak = program.peak_bytes(dev)
    program.reset_peak(dev)
    program.reset_counters()
    i, done, failed, finite = mix["checked_steps"], 0, 0, True
    metrics = b = None
    with tracer:
        t0 = time.perf_counter()
        t1, deadline = t0, t0 + seconds
        while time.perf_counter() < deadline:
            try:
                with tracer.span("making the batch"):
                    b = batch(cell, seed, i, dev)
                with tracer.span("train step (host launching)"):
                    state, metrics = step_fn(state, b)
                with tracer.span("reading the loss"):
                    finite &= bool(torch.isfinite(metrics["loss"]))
            except Exception:  # a step that raises is counted, not fatal
                traceback.print_exc(file=sys.stderr)
                failed += 1
                break
            done, i = done + 1, i + 1
            t1 = time.perf_counter()
    window_peak = program.peak_bytes(dev)
    counts = program.counters()
    trace = tracer.summary(t0, t1) if hasattr(tracer, "summary") else None
    del state, metrics, b, step_fn
    program.release(dev)
    want = reference_records(cell, seed, dev)
    return dict(
        t_window=t0, units=done, attempted=done + failed, failed=failed,
        sound=finite and done > 0 and not failed,
        e2e=dict(train_tokens_per_s=done * tokens_per_step / (t1 - t0)
                 if done else 0.0,
                 peak_mem_gib=window_peak / 2 ** 30),
        memory_peak_bytes=max(setup_peak, window_peak),
        readings=readings(built["records"], want), counters=counts,
        trace=trace)
