#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
``nvcc`` per source, all started together) and drives the main path —
``TNNEngine`` serving GRF-encoded client streams at the full width of the
largest TNN network the repository defines, three ways, the single-bank
entry point ``fire_times_bank``, and the gate-level neuron: that network's
L1 column stack through ``fire_times_bank(..., backend="scan")`` with
``gate_level=True``, for the Catwalk and the sorting-PC dendrite. A first
pass records every distinct call each path makes to the kernel wrappers (RNL
and unary top-k), with its operands; every such call, and the repository's
benchmark shapes and edge cases, is then held bit-exact against its plain
PyTorch version on the card, timed and given its bound. The measured pass
runs each path with the launch counts set to 0 just before it and read just
after, and checks every request's outputs against the CPU reference (the
gate-level paths against the ``fused`` engine on the card and the CPU closed
form). Phases print one JSON line each; the last line is ``{"ok": true,
"device": {...}}``. Any failure raises and exits non-zero; without CUDA it
exits non-zero at once.

Run from the repository root:  python3 chip_smoke.py
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import coding, compaction, layer, network, neuron  # noqa: E402
from repro_torch.core import topk_prune  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import rnl_neuron as rn  # noqa: E402
from repro_torch.kernels import unary_topk as ut  # noqa: E402
from repro_torch.serve import tnn_engine  # noqa: E402

#: H100 SXM device-memory rate, bytes/s (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM int32 ALU rate, ops/s: 132 SMs x 64 INT32 units per SM (Hopper
#: architecture white paper) x 1.98 GHz boost clock.
INT32_OPS_PER_S = 132 * 64 * 1.98e9
#: int32 operations per line-tick of the sweep: subtract, compare, add.
OPS_PER_LINE_TICK = 3

#: the largest TNN network the repository defines
#: (benchmarks/bench_serve_learn.py, full size): 32 features x 16 GRF
#: fields = 512 lines; L1 32 columns x rf 16 x 12 neurons, threshold 10;
#: L2 24 columns x rf 16 x 8 neurons, threshold 8; T = 32, catwalk, k = 3.
N_FEATURES, N_FIELDS, T_STEPS, K = 32, 16, 32, 3
N_SLOTS, N_CLIENTS = 64, 256


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return proc.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median CUDA-event time of one ``fn()`` call in milliseconds: the
    call's wall time on the stream, host overhead between the events
    included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_ms(fn, reps: int = 50, tries: int = 3, key: str = "rnl_"):
    """Device time of the kernel named ``key`` per ``fn()`` call in
    milliseconds, from the profiler's CUDA activity (CUPTI). A profile
    counts only when it recorded exactly one such kernel per call; after
    ``tries`` profiles without such a count it returns None, and the caller
    keeps the CUDA-event time and says so in ``ms_source``."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and key in e.key]
        if sum(e.count for e in hits) == reps:
            return sum(e.self_device_time_total for e in hits) / 1e3 / reps
    return None


def bound_ms(times, weights, fire, clip, t_steps, threshold):
    """Least time the card could take: the larger of the bytes the call must
    move over the memory rate and the int32 operations these inputs need
    over the int32 ALU rate; returns ``(ms, "bytes" | "operations")``.

    Operations per (volley, neuron) pair: one check of each line for the
    pair's sweep bound, then 3 per live line per tick (a live line has
    ``times < t_steps`` and ``w > 0``; the others never add a ramp bit and
    need no work), over the ticks up to the last live line's breakpoint —
    up to the first crossing when no clip is wanted (the kernel stops
    there) and at least one when ``threshold <= 0``."""
    tt = times[..., :, None, :].to(torch.int64)
    ww = weights.to(torch.int64)
    if weights.dim() == times.dim():         # one weight row per neuron
        ww = ww[..., None, :, :]
    live = (tt < t_steps) & (ww > 0)         # (..., B, Q, n)
    t_hi = torch.where(live, tt + ww, 0).amax(dim=-1).clamp(max=t_steps)
    if threshold <= 0:
        t_hi = t_hi.clamp(min=min(1, t_steps))
    if clip is None:
        fired = fire < coding.NO_SPIKE
        t_hi = torch.where(fired, torch.minimum(t_hi, fire + 1), t_hi)
    ops = (OPS_PER_LINE_TICK * int((live.sum(dim=-1) * t_hi).sum())
           + times.shape[-1] * fire.numel())
    nbytes = 4 * (times.numel() + weights.numel() + fire.numel()
                  + (clip.numel() if clip is not None else 0))
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return 1e3 * max(by_bytes, by_ops), \
        ("bytes" if by_bytes > by_ops else "operations")


def synth_clients(n_clients: int, seed: int = 0):
    """Each client: a random-length burst of GRF-encoded feature vectors
    (the client model of examples/serve_tnn.py)."""
    rng = np.random.default_rng(seed)
    streams = []
    for _ in range(n_clients):
        n_cycles = int(rng.integers(1, 7))
        feats = rng.random((n_cycles, N_FEATURES)).astype(np.float32)
        enc = coding.grf_encode(torch.from_numpy(feats), N_FIELDS, T_STEPS)
        streams.append(enc.reshape(n_cycles, -1).numpy())
    return streams


def serve_network(recurrent: bool = False):
    l1 = layer.TNNLayer(n_columns=32, rf_size=16, n_neurons=12, threshold=10,
                        t_steps=T_STEPS, dendrite="catwalk", k=K,
                        recurrent=recurrent)
    l2 = layer.TNNLayer(n_columns=24, rf_size=16, n_neurons=8, threshold=8,
                        t_steps=T_STEPS, dendrite="catwalk", k=K)
    return network.make_network([l1, l2])


def bank_inputs(dev):
    """bench_sparsity's full-size bank: B=Q=n=T=64, density 0.5, weights
    in [0, 8), catwalk k=2, threshold 9."""
    rng = np.random.default_rng(1)
    x = np.where(rng.random((64, 64)) < 0.5, rng.integers(0, 64, (64, 64)),
                 coding.NO_SPIKE).astype(np.int32)
    w = rng.integers(0, 8, (64, 64)).astype(np.int32)
    return torch.from_numpy(x).to(dev), torch.from_numpy(w).to(dev)




#: the TPU kernel each wrapper replaces
REPLACES = {"rnl_fire_times_layer": "src/repro/kernels/rnl_neuron.py:218",
            "rnl_fire_times": "src/repro/kernels/rnl_neuron.py:157",
            "rnl_fire_times_compact": "src/repro/kernels/rnl_neuron.py:276",
            "unary_topk_count": "src/repro/kernels/unary_topk.py:116",
            "unary_topk_relocate": "src/repro/kernels/unary_topk.py:79"}
RNL_WRAPPERS = ("rnl_fire_times_layer", "rnl_fire_times",
                "rnl_fire_times_compact")
SOURCES = {"rnl_neuron": "src/repro_torch/kernels/csrc/rnl_neuron.cu",
           "unary_topk": "src/repro_torch/kernels/csrc/unary_topk.cu"}


def reset_launches() -> None:
    rn.reset_launches()
    ut.reset_launches()


def launch_counts() -> Dict[str, int]:
    return {**rn.LAUNCHES, **ut.LAUNCHES}


@dataclasses.dataclass
class Path:
    """One path of the main path: ``run()`` drives it once through the
    entry points a user calls and returns ``(outputs, stats)``;
    ``check(outputs, stats)`` raises unless they are right and returns the
    fields to print; ``kernel`` is the wrapper the path must launch."""

    name: str
    kernel: str
    run: Callable[[], Tuple[Any, Any]]
    check: Callable[[Any, Any], Dict[str, Any]]


def main_paths(dev, streams, ff, p_ff) -> List[Path]:
    """Three ``TNNEngine`` serve runs at full width — ``auto`` (resolves to
    ``fused`` on CUDA), ``fused_compact``, and L1 recurrent with 4 pipeline
    micro-batches — the single-bank entry point ``fire_times_bank`` at
    bench_sparsity's full size, and the two gate-level paths
    (:func:`gate_level_paths`). Outputs are held against the CPU
    closed-form reference."""
    rec = serve_network(recurrent=True)
    p_rec = network.init_network(torch.Generator().manual_seed(1), rec,
                                 device=dev)
    refs: Dict[int, list] = {}

    def cpu_reference(params, net):
        if id(net) not in refs:
            ref_net = network.make_network([
                dataclasses.replace(lc, backend="closed_form")
                for lc in net.layers])
            cpu = tuple(p.cpu() for p in params)
            refs[id(net)] = [tnn_engine.reference_outputs(cpu, ref_net, s)
                             for s in streams]
        return refs[id(net)]

    def serve_path(name, backend, net, params, micro):
        def run():
            eng = tnn_engine.TNNEngine(
                params, net,
                tnn_engine.TNNServeConfig(n_slots=N_SLOTS, backend=backend,
                                          pipeline_microbatches=micro),
                device=dev)
            return eng.serve(streams), eng.stats()

        def check(results, st):
            engines = {k[6:]: int(v) for k, v in st.items()
                       if k.startswith("steps_")
                       and not k.startswith("steps_predicted_")}
            want_engine = "fused" if backend == "auto" else backend
            if engines != {want_engine: int(st["n_steps"])}:
                raise AssertionError(f"{name}: engines {engines}, expected "
                                     f"every step on {want_engine}")
            for i, (got, want) in enumerate(zip(results,
                                                cpu_reference(params, net))):
                if got.shape != (streams[i].shape[0], 24, 8) \
                        or not np.array_equal(got, want):
                    raise AssertionError(f"{name}: request {i} differs from "
                                         f"the CPU closed-form reference")
            return dict(requests=len(streams), volleys=int(st["n_volleys"]),
                        steps=int(st["n_steps"]),
                        volleys_per_s=st.get("volleys_per_s"),
                        engine_steps=engines,
                        latency_ms_p50=st.get("latency_ms_p50"),
                        bit_exact=True)

        kernel = ("rnl_fire_times_compact" if backend == "fused_compact"
                  else "rnl_fire_times_layer")
        return Path(name, kernel, run, check)

    bank_x, bank_w = bank_inputs(dev)
    bank_cfg = neuron.NeuronConfig(n_inputs=64, threshold=9, t_steps=64,
                                   dendrite="catwalk", k=2)

    def bank_run():
        return neuron.fire_times_bank(bank_x, bank_w, bank_cfg,
                                      backend="auto"), None

    def bank_check(fire, _):
        want = neuron.fire_times_bank(bank_x.cpu(), bank_w.cpu(), bank_cfg,
                                      backend="closed_form")
        if fire.dtype != torch.int32 or not torch.equal(fire.cpu(), want):
            raise AssertionError("single_bank: fire times differ from the "
                                 "CPU closed form")
        return dict(volleys=int(bank_x.shape[0]), bit_exact=True)

    return [serve_path("auto", "auto", ff, p_ff, 1),
            serve_path("fused_compact", "fused_compact", ff, p_ff, 1),
            serve_path("auto_recurrent_pipelined", "auto", rec, p_rec, 4),
            Path("single_bank", "rnl_fire_times", bank_run, bank_check),
            *gate_level_paths(dev, streams, ff, p_ff)]


def gate_level_paths(dev, streams, ff, p_ff) -> List[Path]:
    """The gate-level neuron on the served network's L1 column stack at
    full width (C=32 columns, rf n=16 lines, Q=12 neurons with the served
    L1 weights, T=32, k=3) through ``fire_times_bank(..., backend="scan")``
    with ``gate_level=True``: Catwalk's pruned top-k network (sorter
    'optimal', 31 CAS units) and the sorting-PC dendrite's full bitonic
    sorter (80 units). Two calls each, one unary top-k launch over
    32 x 64 x 12 x 32 = 786,432 rows per call: B=64 served volleys (the
    first of each of the first 64 clients; sparse enough that no tick
    clips) and B=64 random volleys at density 0.5 (bench_sparsity's),
    which do clip. Held bit for bit against the ``fused`` engine on the
    card and the CPU closed form."""
    l1 = ff.layers[0]
    served = torch.from_numpy(np.stack([s[0] for s in streams[:N_SLOTS]]))
    rng = np.random.default_rng(3)
    shape = (l1.n_columns, N_SLOTS, l1.rf_total)
    dense = np.where(rng.random(shape) < 0.5,
                     rng.integers(0, T_STEPS, shape), coding.NO_SPIKE)
    inputs = {"served": layer._gather_rf(served.to(dev), l1).contiguous(),
              "dense": torch.from_numpy(dense.astype(np.int32)).to(dev)}
    w = torch.round(p_ff[0]).to(torch.int32)                  # (C, Q, n)

    def gate_path(dendrite):
        cfg = dataclasses.replace(l1.neuron_config(), dendrite=dendrite,
                                  gate_level=True)
        fast = dataclasses.replace(cfg, gate_level=False)

        def run():
            return {name: neuron.fire_times_bank(x, w, cfg, backend="scan")
                    for name, x in inputs.items()}, None

        def check(fires, _):
            stats = {}
            for name, x in inputs.items():
                fire = fires[name]
                fused = neuron.fire_times_bank(x, w, fast, backend="fused")
                closed = neuron.fire_times_bank(x.cpu(), w.cpu(), fast,
                                                backend="closed_form")
                want = (x.shape[0], x.shape[1], w.shape[1])
                if fire.dtype != torch.int32 or tuple(fire.shape) != want \
                        or not torch.equal(fire, fused) \
                        or not torch.equal(fire.cpu(), closed):
                    raise AssertionError(
                        f"gate_level_{dendrite}/{name}: fire times differ "
                        f"from fused / closed form")
                bq = want + (x.shape[-1],)
                raw = coding.rnl_response_bits(
                    torch.broadcast_to(x[:, :, None, :], bq),
                    torch.broadcast_to(w[:, None, :, :], bq),
                    cfg.t_steps).sum(dim=-1)
                stats[name] = dict(rows=int(raw.numel()),
                                   rows_clipped=int((raw > cfg.k).sum()),
                                   fired=int((fire < coding.NO_SPIKE).sum()))
            return dict(columns=int(w.shape[0]), volleys=N_SLOTS,
                        neurons=int(w.shape[1]), inputs=stats,
                        bit_exact=True)

        return Path(f"gate_level_{dendrite}", "unary_topk_count", run, check)

    return [gate_path("catwalk"), gate_path("sorting_pc")]


def capture(run) -> List[Dict[str, Any]]:
    """Drives ``run()`` with the three RNL wrappers and the unary top-k
    entry spied on. Returns, for each distinct call (wrapper, operand
    shapes, options or network) in first-call order, its number of calls
    and a copy of the operands of its busiest call — the one with the most
    in-cycle spikes (hot bits for unary top-k), so that a pipeline's
    all-silent fill and drain ticks do not stand for the path."""
    cases: Dict[tuple, Dict[str, Any]] = {}
    originals = {name: getattr(rn, name) for name in RNL_WRAPPERS}
    topk = ut._unary_topk

    def spy(name, fn):
        def call(times, weights, **kw):
            key = (name, tuple(times.shape), tuple(weights.shape),
                   tuple(sorted(kw.items())))
            case = cases.setdefault(key, dict(wrapper=name, kw=dict(kw),
                                              calls=0, spikes=-1))
            case["calls"] += 1
            spikes = int((times < kw["t_steps"]).sum())
            if spikes > case["spikes"]:
                case.update(times=times.clone(), weights=weights.clone(),
                            spikes=spikes)
            return fn(times, weights, **kw)
        return call

    def spy_topk(bits, units, n, k, *, count):
        name = "unary_topk_count" if count else "unary_topk_relocate"
        units = tuple(tuple(u) for u in units)
        key = (name, tuple(bits.shape), units, n, k)
        case = cases.setdefault(key, dict(wrapper=name, units=units, n=n,
                                          k=k, calls=0, spikes=-1))
        case["calls"] += 1
        spikes = int((bits != 0).sum())
        if spikes > case["spikes"]:
            case.update(bits=bits.clone(), spikes=spikes)
        return topk(bits, units, n, k, count=count)

    for name, fn in originals.items():
        setattr(rn, name, spy(name, fn))
    ut._unary_topk = spy_topk
    try:
        run()
    finally:
        for name, fn in originals.items():
            setattr(rn, name, fn)
        ut._unary_topk = topk
    return list(cases.values())


def synthetic_cases(dev):
    """(variant, label, times, weights, kwargs) at the repository's
    benchmark shapes and edge cases, all on ``dev``: bench_shard's full
    size (C=64, B=32, rf=16, Q=16, T=64), bench_sparsity's (B=Q=n=T=64,
    compact at density 0.1), ragged B and Q with negative weights and
    spikes at or past the cycle end, threshold <= 0, k set and None."""
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(0)

    def volleys(shape, t_steps, density):
        spike = rng.random(shape) < density
        t = rng.integers(0, t_steps, shape)
        return torch.from_numpy(
            np.where(spike, t, coding.NO_SPIKE).astype(np.int32)).to(dev)

    def weights(shape, lo=0, hi=8):
        return torch.randint(lo, hi, shape, generator=gen,
                             dtype=torch.int32).to(dev)

    shard_x, shard_w = volleys((64, 32, 16), 64, 0.25), weights((64, 16, 16))
    shard = dict(t_steps=64, threshold=9, k=2)
    sp_x, sp_w = bank_inputs(dev)
    sparse = dict(t_steps=64, threshold=9, k=2)
    comp = compaction.compact_volleys(volleys((64, 64), 64, 0.1), 64)
    sp10_c = comp.times.contiguous()
    sp10_w = compaction.gather_weights(sp_w, comp.line_index).contiguous()
    rg_x = volleys((3, 13, 20), 24, 0.6)
    rg_w = weights((3, 11, 20), -2, 8)
    ragged = dict(t_steps=20, threshold=7, k=2)
    thr0 = dict(t_steps=20, threshold=0, k=None)
    rg_comp = compaction.compact_volleys(rg_x[0], 20)
    rg_c = rg_comp.times.contiguous()
    rg_cw = compaction.gather_weights(rg_w[0], rg_comp.line_index)
    rg_cw = rg_cw.contiguous()
    clip = dict(with_clip=True)
    return [
        ("layer", "bench_shard", shard_x, shard_w, shard),
        ("layer", "bench_shard_k_none", shard_x, shard_w,
         {**shard, "k": None}),
        ("layer", "ragged", rg_x, rg_w, ragged),
        ("layer", "ragged_threshold_0", rg_x, rg_w, thr0),
        ("layer+clip", "bench_shard", shard_x, shard_w, {**shard, **clip}),
        ("layer+clip", "ragged", rg_x, rg_w, {**ragged, **clip}),
        ("bank", "bench_sparsity_k_none", sp_x, sp_w, {**sparse, "k": None}),
        ("bank", "ragged", rg_x[0], rg_w[0], ragged),
        ("bank", "ragged_threshold_neg", rg_x[0], rg_w[0],
         {**thr0, "threshold": -3}),
        ("bank+clip", "ragged", rg_x[0], rg_w[0], {**ragged, **clip}),
        ("compact", "bench_sparsity_d0.1", sp10_c, sp10_w, sparse),
        ("compact", "ragged", rg_c, rg_cw, ragged),
        ("compact", "ragged_threshold_0", rg_c, rg_cw, thr0),
    ]


VARIANT = {"rnl_fire_times_layer": "layer", "rnl_fire_times": "bank",
           "rnl_fire_times_compact": "compact"}
WRAPPER = {"layer": "rnl_fire_times_layer", "bank": "rnl_fire_times",
           "compact": "rnl_fire_times_compact"}


def check_and_time(variant, label, x, w, kw, **extra) -> Dict[str, Any]:
    """One launch variant against its plain version on the same inputs on
    the card (bit-exact, or raise), then its times and bound."""
    name = WRAPPER[variant.split("+")[0]]
    fn, plain = getattr(rn, name), getattr(rn, name + "_plain")
    got = fn(x, w, **kw)
    want = plain(x, w, **kw)
    torch.cuda.synchronize()
    got_t = got if isinstance(got, tuple) else (got,)
    want_t = want if isinstance(want, tuple) else (want,)
    err = max(int((g.to(torch.int64) - r.to(torch.int64)).abs().max())
              if g.numel() else 0 for g, r in zip(got_t, want_t))
    if err != 0 or any(g.shape != r.shape or g.dtype != torch.int32
                       for g, r in zip(got_t, want_t)):
        raise AssertionError(f"{variant}/{label}: kernel disagrees with its "
                             f"plain version (max |err| {err})")
    call_ms = time_ms(lambda: fn(x, w, **kw))
    ms = kernel_ms(lambda: fn(x, w, **kw))
    plain_ms = time_ms(lambda: plain(x, w, **kw), reps=5, warmup=1)
    bound, bound_by = bound_ms(x, w, got_t[0],
                               got_t[1] if len(got_t) > 1 else None,
                               kw["t_steps"], kw["threshold"])
    row = dict(variant=variant, shape=label, **extra, times=list(x.shape),
               weights=list(w.shape),
               options={k: v for k, v in kw.items() if k != "with_clip"},
               max_abs_err=err, ms=call_ms if ms is None else ms,
               ms_source="cuda_events" if ms is None else "profiler",
               call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound,
               bound_by=bound_by)
    emit("kernels", **row)
    return row


def topk_bound_ms(rows, n, n_units, out_bytes):
    """Least time the card could take for one unary top-k call: the larger
    of the bytes it must move (each input byte — one per wire — and the
    network table read once, the output written once) over the memory
    rate, and 2 logic operations (AND, OR) per CAS unit for each 32-row
    word over the int32 ALU rate; returns ``(ms, "bytes" | "operations")``.
    """
    nbytes = rows * n + 4 * n_units + out_bytes
    ops = 2 * n_units * -(-rows // 32)
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return 1e3 * max(by_bytes, by_ops), \
        ("bytes" if by_bytes > by_ops else "operations")


def check_topk(label, bits, units, n, k, *, count, timed=True,
               **extra) -> Dict[str, Any]:
    """One unary top-k call against its plain version on the same inputs on
    the card (bit-exact, or raise); when ``timed``, its times, its bound
    and the time of the algebraic shortcut
    ``bits.sum(-1, dtype=int32).clamp_(max=k)`` (the library yardstick:
    it equals the network's count only because the network is a valid
    top-k selector; for the relocate output it computes the count, not the
    k bits)."""
    def fn():
        return ut._unary_topk(bits, units, n, k, count=count)

    def plain():
        return ut._unary_topk_plain(bits, units, n, k, count=count)

    got, want = fn(), plain()
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
        if got.numel() else 0
    if err != 0 or got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"unary_topk/{label}: kernel disagrees with its "
                             f"plain version (max |err| {err})")
    variant = "count" if count else "relocate"
    row = dict(variant=f"unary_topk_{variant}", shape=label, **extra,
               bits=list(bits.shape), dtype=str(bits.dtype).split(".")[-1],
               n=n, k=k, units=len(units), max_abs_err=err)
    if timed:
        call_ms = time_ms(fn)
        ms = kernel_ms(fn, key="unary_topk")
        rows = bits.numel() // n
        bound, bound_by = topk_bound_ms(rows, n, len(units),
                                        got.numel() * got.element_size())
        row.update(ms=call_ms if ms is None else ms,
                   ms_source="cuda_events" if ms is None else "profiler",
                   call_ms=call_ms,
                   plain_ms=time_ms(plain, reps=5, warmup=1),
                   bound_ms=bound, bound_by=bound_by,
                   library_ms=time_ms(lambda: bits.sum(
                       -1, dtype=torch.int32).clamp_(max=k)))
    emit("kernels", **row)
    return row


def synthetic_topk_cases(dev):
    """(label, bits, network, timed) for the unary top-k kernel: the bench
    shape of benchmarks/bench_kernels.py (``topk_network("auto", 64, 2)``,
    selection, 512 rows, density 0.05), timed, then edge cases checked
    only: each load width (16-, 4- and 1-byte, a misaligned view), int8
    input, ragged and empty row counts, the widest row the kernel holds."""
    rng = np.random.default_rng(2)

    def bits(shape, density):
        return torch.from_numpy(rng.random(shape) < density).to(dev)

    auto64 = topk_prune.topk_network("auto", 64, 2)
    bench = bits((512, 64), 0.05)
    misaligned = torch.zeros(1001 * 20 + 1, dtype=torch.bool,
                             device=dev)[1:].view(1001, 20)
    misaligned.copy_(bits((1001, 20), 0.4))
    # odd-even transposition sort: a sorting network for any n
    transposition = [(i, i + 1) for r in range(20)
                     for i in range(r % 2, 19, 2)]
    n20 = topk_prune.prune_topk(transposition, 20, 3)
    l1 = topk_prune.topk_network("optimal", 16, 3)
    return [
        ("bench_kernels_auto64_k2", bench, auto64, True),
        ("ragged_int8", bits((3, 333, 16), 0.3).to(torch.int8), l1, False),
        ("vec4_n20", bits((777, 20), 0.4), n20, False),
        ("vec1_misaligned_n20", misaligned, n20, False),
        ("n256_bitonic_k3", bits((1500, 256), 0.3),
         topk_prune.topk_network("bitonic", 256, 3), False),
        ("rows_0", bits((0, 16), 0.5), l1, False),
    ]


def phase_kernels(dev, captured) -> Dict[str, Dict[str, Any]]:
    """Every launch variant against its plain version on the card: each
    distinct call the main path made (its own operands), the clip variants
    on the main path's layer and bank operands, then the synthetic cases.
    Returns, per wrapper, the row of the call its first path made most (for
    unary top-k, the first path's first call)."""
    main_rows: Dict[str, Dict[str, Any]] = {}
    for path, cases in captured.items():
        for i, case in enumerate(cases):
            if case["wrapper"].startswith("unary_topk"):
                row = check_topk(f"{path}#{i}", case["bits"], case["units"],
                                 case["n"], case["k"],
                                 count=case["wrapper"] == "unary_topk_count",
                                 path=path, calls=case["calls"])
                main_rows.setdefault(case["wrapper"], row)
                continue
            variant = VARIANT[case["wrapper"]]
            x, w, kw = case["times"], case["weights"], case["kw"]
            row = check_and_time(variant, f"{path}#{i}", x, w, kw,
                                 path=path, calls=case["calls"])
            best = main_rows.get(case["wrapper"])
            if best is None or (best["path"] == path
                                and row["calls"] > best["calls"]):
                main_rows[case["wrapper"]] = row
            if variant in ("layer", "bank"):
                check_and_time(variant + "+clip", f"{path}#{i}", x, w,
                               {**kw, "with_clip": True}, path=path)
    for variant, label, x, w, kw in synthetic_cases(dev):
        check_and_time(variant, label, x, w, kw)
    for label, bits, net, timed in synthetic_topk_cases(dev):
        for count in (True, False):
            check_topk(label, bits, net.units, net.n, net.k, count=count,
                       timed=timed)
    return main_rows


def phase_serve(paths, captured) -> Dict[str, Dict[str, int]]:
    """The main path, path by path: every launch count set to 0 just before
    the path runs and read just after. Each path must launch its kernel,
    launch no other, and make exactly the calls the capture pass saw.
    ``run_ms`` is the host clock around the run, ended by a synchronise."""
    launches: Dict[str, Dict[str, int]] = {}
    for path in paths:
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        out, st = path.run()
        torch.cuda.synchronize()
        run_ms = 1e3 * (time.perf_counter() - t0)
        counts = launch_counts()
        launches[path.name] = counts
        fields = path.check(out, st)
        emit("serve", run=path.name, **fields, run_ms=run_ms,
             launches=counts)
        seen = {name: 0 for name in REPLACES}
        for case in captured[path.name]:
            seen[case["wrapper"]] += case["calls"]
        if counts[path.kernel] <= 0:
            raise AssertionError(f"{path.name}: {path.kernel} was not "
                                 f"launched")
        if counts != seen or any(n for name, n in counts.items()
                                 if name != path.kernel):
            raise AssertionError(f"{path.name}: launches {counts}, calls "
                                 f"{seen}, expected only {path.kernel}")
    return launches


def device_share(prof, wall_ms):
    """Device busy time (the sum of the CUDA activity: kernels and copies),
    the idle share 1 - busy / wall, and the top device ops."""
    dev_events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev_events) / 1e3
    top = sorted(dev_events, key=lambda e: -e.self_device_time_total)[:8]
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                idle_share=1.0 - busy_ms / wall_ms,
                device_ops=sum(e.count for e in dev_events),
                top=[dict(name=e.key[:80], count=e.count,
                          ms=e.self_device_time_total / 1e3) for e in top])


def phase_profile_path(path):
    """Where one main-path run's time goes: ``path.run()`` (already warm)
    under the profiler; the profiler's host cost makes the idle share an
    upper estimate."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        path.run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    emit("profile", run=path.name, **device_share(prof, wall_ms))


def phase_profile(dev, streams, ff, p_ff):
    """Where a serve step's time goes: the ``auto`` run under the profiler.
    Device busy time is the sum of the CUDA activity (kernels and copies);
    the idle share is 1 - busy / wall. The profiler's own host cost makes
    the wall, and so the idle share, an upper estimate."""
    eng = tnn_engine.TNNEngine(p_ff, ff,
                               tnn_engine.TNNServeConfig(n_slots=N_SLOTS),
                               device=dev)
    eng.serve(streams[:N_SLOTS])             # warm the path
    for s in streams:
        eng.submit(s)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps = 0
        while eng.pool.has_work:
            eng.step()
            steps += 1
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    emit("profile", run="auto", steps=steps, **device_share(prof, wall_ms))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2

    dev = torch.device("cuda")
    smi = smi_line()
    t0 = time.perf_counter()
    build.build_all(list(SOURCES))
    rn._library()
    ut._library()
    build_s = time.perf_counter() - t0
    ptxas = {}
    for name in SOURCES:
        log = build.library_path(name).parent / "nvcc.log"
        ptxas[name] = [ln.strip() for ln in log.read_text().splitlines()
                       if "registers" in ln or "spill" in ln] \
            if log.exists() else []
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), nvidia_smi=smi,
         kernel_build_s=build_s, ptxas=ptxas)

    streams = synth_clients(N_CLIENTS)
    ff = serve_network()
    p_ff = network.init_network(torch.Generator().manual_seed(0), ff,
                                device=dev)
    paths = main_paths(dev, streams, ff, p_ff)
    # capture pass (also the warm-up): each path's calls and operands
    captured = {path.name: capture(path.run) for path in paths}
    main_rows = phase_kernels(dev, captured)
    launches = phase_serve(paths, captured)
    phase_profile(dev, streams, ff, p_ff)
    for path in paths:
        if path.name.startswith("gate_level"):
            phase_profile_path(path)

    kernels = []
    for name, row in main_rows.items():
        by_run = {path.name: launches[path.name][name] for path in paths
                  if path.kernel == name}
        source = SOURCES["unary_topk" if name.startswith("unary_topk")
                         else "rnl_neuron"]
        kernels.append(dict(
            name=name, route="cuda", source=source,
            replaces=REPLACES[name], launches=sum(by_run.values()),
            launches_by_run=by_run, shape=row["shape"],
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            ms_source=row["ms_source"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row.get("library_ms")))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
