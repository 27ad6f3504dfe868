#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
``nvcc`` per source, all started together) and drives the main path —
``TNNEngine`` serving GRF-encoded client streams at the full width of the
largest TNN network the repository defines, three ways, the single-bank
entry point ``fire_times_bank``, the gate-level neuron (that network's L1
column stack through ``fire_times_bank(..., backend="scan")`` with
``gate_level=True``, for the Catwalk and the sorting-PC dendrite: one
launch of the gate-level kernel a call, which makes the ramp bits on the
card; and the same stack's bit-planes, made by ``rnl_response_bits``,
through ``unary_topk_count``, the bit-plane kernel), learning while
serving (``TNNEngine(learn=True)`` on benchmarks/bench_serve_learn.py's
workload: learning off, STDP every step, every 4th step, seeded, on
``fused_compact``, and at 64 slots; each held against a manual
``network.step`` loop on the card and one step against the CPU),
durability (``serve_resilient`` through an injected worker failure on the
serve population and on the learning workload with and without the seeded
rule, held against the uninterrupted paths and against a fresh engine
built from the restored snapshot; ``TNNEngine(..., resume=True)`` on that
snapshot; ``AsyncTNNEngine`` serving the 256 clients at once), the
column trainer ``train_column`` on the clustering example's stream (one
single-bank launch a volley, held bit-exact against the CPU),
mamba2-780m inference at full width and depth with random weights (the
prefill forward, ``forward(..., logits_mode="last")``, with the SSD scan
kernel once per layer, and ``Engine.generate``, whose decode is the
one-token recurrence: no kernel), and deepseek-v2-lite-16b (MLA + MoE)
inference at full width and depth with random weights (the prefill forward
and continuous and wave ``Engine.serve`` through 6 slots, the MoE gate
kernel once per layer per forward and per decode step); once those
models are freed, the last three LM families at full width and depth with
random weights, one model at a time: phi-3-vision-4.2b (the prefill
forward after 1,024 patch embeddings, and continuous ``Engine.serve``
through 4 slots, each request held equal to itself served alone),
seamless-m4t-medium (the prefill forward over 1,024 frames, and
``Engine.generate(frames=)``) and zamba2-1.2b (the prefill forward, the
SSD kernel once in each of its 38 layers, and ``Engine.generate``, whose
decode launches no kernel), each with its prefill time, a profiled prefill
and decode step, and float32 checks against the CPU's float64 forward and
its own cached decode; and LM training through the launcher
``repro_torch.launch.train``: internlm2-1.8b, mamba2-780m (with top-k
gradient compression) and zamba2-1.2b at full width and depth, bf16,
remat on, 3 steps of 8 x 4,096 tokens in 4 microbatches (the SSD kernel
in every layer's forward and recompute), and deepseek-v2-lite-16b at the
smoke size (the MoE gate under autograd), each with its launch counts
(the full-width three with a profiled step); beside them a float32
step of each of the six families on the card against the CPU (and
deepseek's under ``--opt``), remat on against off,
the task gradient reaching every mamba2 leaf and the router, a launcher
run restarted from its checkpoint against the uninterrupted run, and the
kernels' autograd functions against plain autograd at the training
shapes. A first pass
records every call each path makes to the kernel wrappers (RNL, unary
top-k, gate level, SSD scan, MoE gate), with its operands; those calls, and the
repository's benchmark shapes and edge cases (for the RNL kernels also
the sizes their launchers once refused: 2,048 lines, 262,148 volleys),
are then held against their plain PyTorch versions on the card
(bit-exact for the integer kernels and the gate's ids; the SSD scan and
the gate's probabilities to stated tolerances), timed and given their
bounds, beside the launch floor (a one-element ``fill_``). The measured pass runs each
path with the launch counts set to 0 just before it and read just after,
and checks its outputs (TNN requests against the CPU reference, the
gate-level paths against the ``fused`` engine and the CPU closed form,
served MoE requests against each request served alone). The
learning-cost phase also reports the overhead of async snapshots every 50
steps. The profile phase adds a learning step at 4 and 64 slots with its STDP ops named. The
mesh phase then puts the TNN stack on a ``("data", "column")`` mesh of
world size 1 (NCCL, ``specs.tnn_mesh()``; ``tnn_mesh(2, 1)`` must refuse
one card): ``TNNEngine(mesh=)`` on ``auto``, ``fused_compact``, L1
recurrent with 4 micro-batches, learning every step and
``serve_resilient`` through a failure, each bit-exact against its
single-device path with the sharded wrappers launching once per layer per
step; the per-step wall of the mesh engine against the single-device one;
each served stack on a column axis that does not divide it, through the
unsharded kernel on a rank's replicated block; and every rank's tile of 2-, 4- and 8-way column by 1- and 2-way data
meshes launched one after another through the wrappers, each tiling
equal to the whole launch, each tile shape timed beside its bound. The
LM phase then holds each layer's Mamba2 block (the kernel) against
token-by-token decode (the recurrence), greedy generation against the
forward's argmax, and the card's float32 forward against the CPU's
float64 one; the MoE phase holds each MLA block against its cached
decode, a 2-layer model's forward against its decode, and the card's
float32 forward against the CPU's float64 one. The LM mesh phase then
puts the LM path on a ``("data", "model")`` mesh of world size 1 (NCCL,
``specs.lm_mesh()``; ``lm_mesh(2, 1)`` must refuse one card): the
deepseek-v2-lite prefill under ``--opt`` (the expert-parallel layer)
through ``forward(..., mesh=)`` bit-exact against the forward without a
mesh at one gate launch a layer; every rank's part of the first MoE layer
for 2-, 4- and 8-way model by 1- and 2-way data tilings launched one
after another, each tiling's summed parts against ``moe_apply`` at a
drop-free capacity, its drops at capacity 1.0 and its time; the same
tilings of the plain MoE layer's rank parts (each part E / m experts with
its d_ff block, the whole batch's capacity and drops, one gate launch a
part) combined as the collectives would and held against the whole
layer, and the plain layer's prefill through the mesh bit-exact; every
rank's part of one layer under 2-, 4- and 8-way tensor parallelism
(internlm2-1.8b's dense block, deepseek's MLA attention, mamba2-780m's
SSM block with the SSD kernel on the rank's heads, the
vocabulary-parallel cross-entropy over internlm2's head), combined as
the collectives would and held against the whole layer, with the
state bytes per rank from the spec tree; the
mesh train step of deepseek (``--opt`` and the plain layer) at the
smoke size bit-exact against the single-device step; and 16 steps of
``decode_step(...,
mesh=)`` after a 4 x 2,048 prefill for deepseek (``--opt``: one gate
launch a layer a step), internlm2-1.8b and mamba2-780m at full width,
each bit-exact against the decode without a mesh (zamba2-1.2b's too, in
its family phase: its site caches gathered one site at a time), and
again with the state donated (``decode_step(..., donate=True)``): the
logits and final state bit-exact against the functional mesh run's, the
step's memory beyond its state lower by about the cache stack. Before
training, llama3.2-3b's forward at full width on one (16, 16) rank's rows
of prefill_32k (2 x 32,768 tokens, every head: attention scored in blocks
of queries) peaks within 1 % of the dry run's count of the same step, and
its blocked float32 logits equal its whole-attention ones within 1e-4 of
scale. The training phase then repeats
internlm2-1.8b's and mamba2-780m's (``--opt``) full-width launcher runs
through the mesh step on a world-size-1 mesh (the state made as blocks
by ``init_train_state(mesh=)``), each held bit for bit against the
single-device run's losses and final state. Last, the dry run
(``repro_torch.launch.dryrun``) traces ten production cells on the host
(fake ranks, no device; each line says whether the rank fits the card)
and its counter is held against one real step of internlm2-1.8b's
launcher run on the card, whose state is donated as the launcher donates
it: the argument bytes and the FLOPs equal, ``max_memory_allocated``
within 1 % of the predicted peak and below the functional step's peak;
two donated steps equal two functional ones (losses and every leaf's
checksum). Phases
print one JSON line each; the last line is ``{"ok": true, "device": {...}}``. Any
failure raises and exits non-zero; without CUDA it exits non-zero at
once.

Run from the repository root:  python3 chip_smoke.py
"""

from __future__ import annotations

import asyncio
import dataclasses
import datetime
import gc
import json
import math
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = pathlib.Path(__file__).resolve().parent
if not (ROOT / "src" / "repro_torch").is_dir():
    # the script alone, without the port beside it: nothing to run
    print(f"chip_smoke: no src/repro_torch under {ROOT}; run it from the "
          f"repository's root", file=sys.stderr)
    sys.exit(1)
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import coding, column, compaction, layer  # noqa: E402
from repro_torch.core import network, neuron, stdp  # noqa: E402
from repro_torch.core import sorting_networks, topk_prune  # noqa: E402
from repro_torch.configs import registry as lm_registry  # noqa: E402
from repro_torch.data import pipeline as DP  # noqa: E402
from repro_torch.data import tokenizer  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import gqa_attention as ga  # noqa: E402
from repro_torch.kernels import moe_gate as mg  # noqa: E402
from repro_torch.kernels import rnl_neuron as rn  # noqa: E402
from repro_torch.kernels import rnl_shard as rs  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402
from repro_torch.kernels import unary_topk as ut  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models import transformer as lm  # noqa: E402
from repro_torch.optim import grad_compression as GC  # noqa: E402
from repro_torch.optim import optimizers as O  # noqa: E402
from repro_torch.optim.tree import tree_leaves, tree_unflatten  # noqa: E402
from repro_torch.roofline import analysis as roofline  # noqa: E402
from repro_torch.roofline.op_cost import tensor_bytes  # noqa: E402
from repro_torch.serve import tnn_engine  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402
from repro_torch.sharding import specs  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import fault_tolerance  # noqa: E402
from repro_torch.train import train_loop as TL  # noqa: E402

from examples import tnn_clustering_torch as clustering  # noqa: E402

#: H100 SXM device-memory rate, bytes/s (NVIDIA data sheet;
#: repro_torch.roofline.analysis).
HBM_BYTES_PER_S = roofline.HBM_BW
#: H100 SXM int32 ALU rate, ops/s: 132 SMs x 64 INT32 units per SM (Hopper
#: architecture white paper) x 1.98 GHz boost clock.
INT32_OPS_PER_S = 132 * 64 * 1.98e9
#: int32 operations per line-tick of the sweep: subtract, compare, add.
OPS_PER_LINE_TICK = 3
#: H100 SXM dense tensor-core rates, FLOP/s (NVIDIA data sheet): bf16
#: (repro_torch.roofline.analysis), and TF32 taken three times over, the
#: float32-accurate split of each product (3xTF32): the peaks for the SSD
#: scan's bf16 and float32 inputs.
BF16_FLOPS_PER_S = roofline.PEAK_FLOPS
F32_SPLIT_FLOPS_PER_S = 495e12 / 3

#: the largest TNN network the repository defines
#: (benchmarks/bench_serve_learn.py, full size): 32 features x 16 GRF
#: fields = 512 lines; L1 32 columns x rf 16 x 12 neurons, threshold 10;
#: L2 24 columns x rf 16 x 8 neurons, threshold 8; T = 32, catwalk, k = 3.
N_FEATURES, N_FIELDS, T_STEPS, K = 32, 16, 32, 3
N_SLOTS, N_CLIENTS = 64, 256

#: learning while serving: benchmarks/bench_serve_learn.py's full-size
#: workload on that network — 64 clients, each burst tiled to 8 cycles, 4
#: slots: 128 engine steps, all slots full
LEARN_CLIENTS, LEARN_CYCLES, LEARN_SLOTS = 64, 8, 4
#: one-step weight tolerance, card against the CPU
STDP_ATOL = 2e-6
#: durability: the serve run snapshots every 4 steps (synchronous saves)
#: and loses a worker at the first step_id >= 10, so it restores step 8;
#: the learning runs snapshot every 50 steps off the serve thread
#: (bench_serve_learn's cadence) and lose one at step_id 75 (restore 50);
#: the resumed engine then serves this many more clients
SERVE_SNAPSHOT_EVERY, SERVE_FAIL_AT = 4, 10
LEARN_SNAPSHOT_EVERY, LEARN_FAIL_AT = 50, 75
RESUME_CLIENTS = 8
#: the clustering example's stream (examples/tnn_clustering_torch.py)
CLUSTER_VOLLEYS = 600

#: the LM path: the repository's only attention-free model
#: (configs/mamba2_780m.py) at full width and depth, bf16; prefill of B
#: sequences of L tokens; generation for N_PROMPTS prompts of 16-128 tokens.
LM_ARCH = "mamba2-780m"
PREFILL_B, PREFILL_L = 4, 2048
N_PROMPTS, NEW_TOKENS = 8, 32

#: the MoE path: deepseek-v2-lite-16b (configs/deepseek_v2_lite_16b.py) at
#: full width and depth, bf16; prefill of B x S tokens (T = 8,192, as the
#: mamba2 prefill); continuous serving of benchmarks/bench_serve_lm.py's
#: request population, quartered (12 requests of 1-24 prompt tokens, 16
#: new tokens each, max_len 24 + 16 + 2) through 6 slots: each request is
#: served three times more (wave, alone, the capture pass), all
#: host-bound: at 24 requests the path took up to 247 s. Six slots is
#: top_k: the catwalk capacity is then t = 6, so no assignment can drop
#: and each row's tokens depend on its own request only.
MOE_ARCH = "deepseek-v2-lite-16b"
MOE_PREFILL_B, MOE_PREFILL_S = 4, 2048
MOE_REQUESTS, MOE_MAX_PROMPT, MOE_NEW_TOKENS, MOE_SLOTS = 12, 24, 16, 6
#: the requests also served alone through one slot, reported beside the
#: gated checks (each such serve takes ~2.5 s of host time)
MOE_ONE_SLOT = 6

#: the last three LM families at full width and depth, bf16, random
#: weights, one model alive at a time. vlm: phi-3-vision-4.2b
#: (configs/phi3_vision_4_2b.py), prefill of B x (the config's 1,024 patch
#: embeddings + S text tokens) and continuous serving of 12 requests of
#: 1-24 tokens through 4 slots. audio: seamless-m4t-medium
#: (configs/seamless_m4t_medium.py), B x the config's 1,024 frames with S
#: text tokens, and Engine.generate(frames=) on B prompts of up to 24
#: tokens. hybrid: zamba2-1.2b (configs/zamba2_1_2b.py), prefill of B x L
#: tokens (the SSD kernel in each of its 38 layers) and the static
#: Engine.generate on B prompts (the recurrence: no kernel).
VLM_ARCH, AUDIO_ARCH, HYBRID_ARCH = ("phi-3-vision-4.2b",
                                     "seamless-m4t-medium", "zamba2-1.2b")
VLM_B, VLM_S = 4, 512
VLM_REQUESTS, VLM_MAX_PROMPT, VLM_NEW_TOKENS, VLM_SLOTS = 12, 24, 16, 4
AUDIO_B, AUDIO_S = 4, 64
AUDIO_MAX_PROMPT, AUDIO_NEW_TOKENS = 24, 16
HYBRID_B, HYBRID_L = 4, 2048
HYBRID_NEW_TOKENS = 16


def ptxas_report(name: str) -> List[Dict[str, Any]]:
    """Registers, spills and static shared memory of each kernel in
    ``csrc/<name>.cu``, from the ``-Xptxas -v`` report that the build keeps
    beside the library (``nvcc.log``)."""
    log = build.library_path(name).parent / "nvcc.log"
    out: List[Dict[str, Any]] = []
    for ln in log.read_text().splitlines() if log.exists() else []:
        if "Compiling entry function" in ln:
            out.append(dict(entry=ln.split("'")[1]))
        elif out and "spill stores" in ln:
            words = ln.replace(",", "").split()
            out[-1].update(stack_bytes=int(words[0]),
                           spill_store_bytes=int(words[4]),
                           spill_load_bytes=int(words[8]))
        elif out and "Used" in ln and "registers" in ln:
            words = ln.replace(",", "").split()
            out[-1]["registers"] = int(words[words.index("registers") - 1])
            out[-1]["static_smem_bytes"] = int(
                words[words.index("smem") - 2]) if "smem" in words else 0
    return out


#: the script's start on the host clock: each line carries its seconds
#: since then (``t``), the timeline of a run
T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields,
                      "t": round(time.perf_counter() - T0, 1)}), flush=True)


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
    """Device time of the kernels named ``key`` per ``fn()`` call in
    milliseconds, from the profiler's CUDA activity (CUPTI), and how many
    of them one call launches: ``(ms, kernels_per_call)``. A profile counts
    only when it recorded a whole number (at least one) of such kernels per
    call; after ``tries`` profiles without one it returns ``(None, None)``,
    and the caller keeps the CUDA-event time and says so in
    ``ms_source``."""
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
        count = sum(e.count for e in hits)
        if count and count % reps == 0:
            return (sum(e.self_device_time_total for e in hits) / 1e3 / reps,
                    count // reps)
    return None, None


def launch_floor_ms() -> float:
    """The launch floor as the profiler sees it: the device time of a
    ``fill_`` of one float32 element on the card, the least a kernel
    launch shows there. Raises when the profiler records no such
    kernel."""
    one = torch.empty(1, device="cuda")
    ms, _ = kernel_ms(lambda: one.fill_(1.0), key="Fill")
    if ms is None:
        raise AssertionError("launch floor: the profiler saw no fill kernel")
    return ms


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
            "unary_topk_relocate": "src/repro/kernels/unary_topk.py:79",
            "gate_level_trace": "src/repro/kernels/unary_topk.py:79",
            "ssd_scan": "src/repro/kernels/ssd_scan.py:68",
            "moe_gate_topk": "src/repro/kernels/moe_gate.py:54"}
RNL_WRAPPERS = ("rnl_fire_times_layer", "rnl_fire_times",
                "rnl_fire_times_compact")
SOURCES = {"rnl_neuron": "src/repro_torch/kernels/csrc/rnl_neuron.cu",
           "unary_topk": "src/repro_torch/kernels/csrc/unary_topk.cu",
           "ssd_scan": "src/repro_torch/kernels/csrc/ssd_scan.cu",
           "moe_gate": "src/repro_torch/kernels/csrc/moe_gate.cu",
           "gqa_attention": "src/repro_torch/kernels/csrc/gqa_attention.cu"}
#: the source each wrapper launches
SOURCE_OF = {**{name: "rnl_neuron" for name in RNL_WRAPPERS},
             "unary_topk_count": "unary_topk",
             "unary_topk_relocate": "unary_topk",
             "gate_level_trace": "unary_topk", "ssd_scan": "ssd_scan",
             "moe_gate_topk": "moe_gate", "gqa_attention": "gqa_attention"}
#: the kernel that replaces no TPU kernel (the reference's attention is
#: plain ``jnp``): a path's launches of it are its ``attention`` count
ATTENTION_KERNEL = "gqa_attention"


def reset_launches() -> None:
    rn.reset_launches()
    ut.reset_launches()
    ss.reset_launches()
    mg.reset_launches()
    ga.reset_launches()


def launch_counts() -> Dict[str, int]:
    return {**rn.LAUNCHES, **ut.LAUNCHES, **ss.LAUNCHES, **mg.LAUNCHES,
            **ga.LAUNCHES}


def gqa_calls(cfg) -> int:
    """The fused attention kernel's launches in one forward of ``cfg``
    without a cache: one for each GQA attention whose operands it takes
    (bf16, a head dim it is built for) — every layer of a dense or vision
    model, each shared-block site of a hybrid, the audio model's encoder
    layers and its decoder's self- and cross-attention; none in MLA or SSD
    layers."""
    if cfg.mla is not None or cfg.family == "ssm" \
            or cfg.dtype != "bfloat16" \
            or cfg.resolved_head_dim not in ga.HEAD_DIMS:
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid.period
    if cfg.family == "audio":
        return cfg.encdec.n_encoder_layers + 2 * cfg.n_layers
    return cfg.n_layers


def gqa_train_calls(cfg, microbatches: int) -> int:
    """The kernel's launches in ``microbatches`` forward-backward passes:
    each forward's, and again in the block remat's recompute."""
    return (2 if cfg.remat == "block" else 1) * gqa_calls(cfg) * microbatches


def engine_steps(st) -> Dict[str, int]:
    """Steps per neuron-bank engine, from a ``TNNEngine.stats()``."""
    return {k[6:]: int(v) for k, v in st.items()
            if k.startswith("steps_") and not k.startswith("steps_predicted_")}


@dataclasses.dataclass
class Path:
    """One path of the main path: ``run()`` drives it once through the
    entry points a user calls and returns ``(outputs, stats)``;
    ``check(outputs, stats)`` raises unless they are right and returns the
    fields to print; ``kernel`` is the wrapper the path must launch (None:
    it must launch none), ``launches`` how often, where that is fixed (an
    int, or a function of the run's stats); ``attention`` how often it
    launches the fused attention kernel (:data:`ATTENTION_KERNEL`), beside
    its own (an int, or a function of the run's stats)."""

    name: str
    kernel: Optional[str]
    run: Callable[[], Tuple[Any, Any]]
    check: Callable[[Any, Any], Dict[str, Any]]
    launches: Any = None
    attention: Any = 0


def main_paths(dev, streams, ff, p_ff, served) -> List[Path]:
    """Three ``TNNEngine`` serve runs at full width — ``auto`` (resolves to
    ``fused`` on CUDA), ``fused_compact``, and L1 recurrent with 4 pipeline
    micro-batches — the single-bank entry point ``fire_times_bank`` at
    bench_sparsity's full size, and the two gate-level paths
    (:func:`gate_level_paths`). Outputs are held against the CPU
    closed-form reference; each serve run's outputs are kept in
    ``served`` under its name for later paths to be held against."""
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
            served[name] = eng.serve(streams)
            return served[name], eng.stats()

        def check(results, st):
            engines = engine_steps(st)
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
    sorter (80 units). Two calls each, one gate-level launch each over
    32 x 64 x 12 = 24,576 (volley, neuron) pairs of 32 ticks: B=64 served
    volleys (the first of each of the first 64 clients; sparse enough that
    no tick clips) and B=64 random volleys at density 0.5
    (bench_sparsity's), which do clip. Held bit for bit against the
    ``fused`` engine on the card and the CPU closed form. Then the same
    stack's bit-planes (32 x 64 x 12 x 32 = 786,432 rows of 16 wires, made
    by ``coding.rnl_response_bits``) through the bit-plane kernel's entry
    ``unary_topk_count`` with Catwalk's network, one launch per plane,
    held against ``min(popcount, k)``."""
    l1 = ff.layers[0]
    served = torch.from_numpy(np.stack([s[0] for s in streams[:N_SLOTS]]))
    rng = np.random.default_rng(3)
    shape = (l1.n_columns, N_SLOTS, l1.rf_total)
    dense = np.where(rng.random(shape) < 0.5,
                     rng.integers(0, T_STEPS, shape), coding.NO_SPIKE)
    inputs = {"served": layer._gather_rf(served.to(dev), l1).contiguous(),
              "dense": torch.from_numpy(dense.astype(np.int32)).to(dev)}
    w = torch.round(p_ff[0]).to(torch.int32)                  # (C, Q, n)
    bq = (l1.n_columns, N_SLOTS, w.shape[1], l1.rf_total)

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

        return Path(f"gate_level_{dendrite}", "gate_level_trace", run, check,
                    launches=len(inputs))

    net = topk_prune.topk_network("optimal", l1.rf_total, K)
    planes = {name: coding.rnl_response_bits(
        torch.broadcast_to(x[:, :, None, :], bq),
        torch.broadcast_to(w[:, None, :, :], bq), T_STEPS)
        for name, x in inputs.items()}

    def plane_run():
        return {name: ut.unary_topk_count(bits, net)
                for name, bits in planes.items()}, None

    def plane_check(counts, _):
        for name, bits in planes.items():
            want = bits.sum(dim=-1, dtype=torch.int32).clamp_(max=K)
            if counts[name].dtype != torch.int32 \
                    or not torch.equal(counts[name], want):
                raise AssertionError(f"gate_level_bitplane/{name}: counts "
                                     f"differ from min(popcount, k)")
        return dict(rows=int(planes["dense"].numel() // l1.rf_total),
                    planes=len(planes), bit_exact=True)

    return [gate_path("catwalk"), gate_path("sorting_pc"),
            Path("gate_level_bitplane", "unary_topk_count", plane_run,
                 plane_check, launches=len(planes))]


def learn_population(streams, n_clients: int, n_cycles: int):
    """bench_serve_learn's fixed-length population: the first ``n_clients``
    client bursts (cyclically), each tiled to ``n_cycles`` volleys, so
    every engine variant steps the same batch sequence."""
    pop = []
    for i in range(n_clients):
        s = streams[i % len(streams)]
        pop.append(np.tile(s, (-(-n_cycles // s.shape[0]), 1))[:n_cycles])
    return pop


def weight_agreement(want, got) -> Dict[str, Any]:
    """How far two weight tuples are apart: the largest float difference
    and the count of rounded weights that differ."""
    diff = max(float((a.cpu() - b.cpu()).abs().max()) for a, b in
               zip(want, got))
    flips = sum(int((torch.round(a.cpu()) != torch.round(b.cpu())).sum())
                for a, b in zip(want, got))
    return dict(max_abs_diff=diff, rounded_differ=flips)


def check_one_step(dev, net, params, batch) -> Dict[str, Any]:
    """One ``network.step`` from ``params`` on ``batch``, the card against
    the port's CPU closed form: outputs and winners bit-exact, float
    weights within ``STDP_ATOL``, rounded weights equal; raises
    otherwise."""
    cpu_net = network.make_network([
        dataclasses.replace(lc, backend="closed_form") for lc in net.layers])
    got = network.step(params, batch.to(dev), net)
    want = network.step(tuple(p.cpu() for p in params), batch.cpu(), cpu_net)
    agree = weight_agreement(want.params, got.params)
    if not torch.equal(got.out.cpu(), want.out) or not all(
            torch.equal(a.cpu(), b) for a, b in zip(got.winners,
                                                    want.winners)):
        raise AssertionError(f"network.step at B={batch.shape[0]}: outputs "
                             f"or winners differ from the CPU closed form")
    if agree["max_abs_diff"] > STDP_ATOL or agree["rounded_differ"]:
        raise AssertionError(f"network.step at B={batch.shape[0]}: weights "
                             f"{agree} against the CPU closed form")
    return dict(batch=int(batch.shape[0]), **agree)


def manual_learning_run(dev, pop, net, params, every, seed,
                        n_steps: Optional[int] = None):
    """A learning engine's step sequence on ``pop`` by hand (groups of
    ``LEARN_SLOTS`` clients fill the slots in order and retire together),
    through ``network.step`` on the steps the cadence learns and
    ``network.forward`` on the others, for ``n_steps`` steps (all when
    None). Returns each client's outputs and the final weights."""
    p, outs, step_id = params, [[] for _ in pop], 0
    for g in range(0, len(pop), LEARN_SLOTS):
        for c in range(LEARN_CYCLES):
            if step_id == n_steps:
                return [np.stack(o) for o in outs if o], p
            x = torch.from_numpy(np.stack(
                [s[c] for s in pop[g:g + LEARN_SLOTS]])).to(dev)
            if step_id % every == 0:
                key = (None if seed is None else
                       torch.Generator(device=dev).manual_seed(
                           tnn_engine.stdp_step_seed(seed, step_id)))
                res = network.step(p, x, net, key=key)
                p = res.params
            else:
                res = network.forward(p, x, net)
            out = res.out.cpu().numpy()
            for i in range(LEARN_SLOTS):
                outs[g + i].append(out[i])
            step_id += 1
    return [np.stack(o) for o in outs], p


def learn_paths(dev, streams, ff, p_ff, served) -> List[Path]:
    """Learning while serving at the served network's full width:
    bench_serve_learn's workload (64 clients x 8 cycles through 4 slots,
    128 steps) through ``TNNEngine`` on ``auto`` (→ ``fused``) with
    learning off, STDP every step, every 4th step, every step with the
    stochastic rule (``stdp_seed=0``), and every step on ``fused_compact``;
    then the serve path's size (64 slots, the 256 clients, every step), so
    that the STDP reduction runs at B = 64. Held: a learning engine's first
    step equals learning off; each engine's outputs and final weights equal
    a manual ``network.step`` loop over the same batches on the card (the
    compact engine: the ``fused`` engine's); one ``network.step`` equals
    the CPU closed form (weights within ``STDP_ATOL``); the seeded run
    gives the same weights each time; the STDP update counts. Reported,
    not held: the whole run's weights and outputs against the same run on
    the CPU (a B-way float32 sum on the card may round differently).
    Each run's outputs and final weights are kept in ``served`` under its
    name."""
    pop = learn_population(streams, LEARN_CLIENTS, LEARN_CYCLES)
    cpu_net = network.make_network([
        dataclasses.replace(lc, backend="closed_form") for lc in ff.layers])
    last = served
    seeded: List[Tuple[torch.Tensor, ...]] = []

    def engine(n_slots, backend, dev_, params, net, **kw):
        return tnn_engine.TNNEngine(
            params, net, tnn_engine.TNNServeConfig(
                n_slots=n_slots, backend=backend, **kw), device=dev_)

    def learn_path(name, population, n_slots, backend="auto", every=None,
                   seed=None):
        learn = every is not None
        kw = dict(learn=True, stdp_every=every, stdp_seed=seed) \
            if learn else {}
        want_engine = "fused" if backend == "auto" else backend
        kernel = ("rnl_fire_times_compact" if backend == "fused_compact"
                  else "rnl_fire_times_layer")

        def run():
            eng = engine(n_slots, backend, dev, p_ff, ff, **kw)
            results = eng.serve(population)
            last[name] = (results, eng.params)
            if seed is not None:
                seeded.append(eng.params)
            return (results, eng.params), eng.stats()

        def check(outputs, st):
            results, params = outputs
            engines = engine_steps(st)
            steps = int(st["n_steps"])
            if engines != {want_engine: steps}:
                raise AssertionError(f"{name}: engines {engines}, expected "
                                     f"every step on {want_engine}")
            full = LEARN_CLIENTS * LEARN_CYCLES // LEARN_SLOTS
            if n_slots == LEARN_SLOTS and steps != full:
                raise AssertionError(f"{name}: {steps} steps, expected "
                                     f"{full}")
            # step_id 0, every, 2 * every, ... learn
            updates = 0 if not learn else -(-steps // every)
            if int(st["n_stdp_updates"]) != updates:
                raise AssertionError(f"{name}: {st['n_stdp_updates']} STDP "
                                     f"updates, expected {updates}")
            for i, (got, s) in enumerate(zip(results, population)):
                if got.shape != (s.shape[0], 24, 8) or got.dtype != np.int32:
                    raise AssertionError(f"{name}: request {i} has shape "
                                         f"{got.shape}")
            fields = dict(requests=len(population),
                          volleys=int(st["n_volleys"]), steps=steps,
                          n_slots=n_slots, stdp_updates=updates,
                          volleys_per_s=st.get("volleys_per_s"),
                          latency_ms_p50=st.get("latency_ms_p50"),
                          run_s=st["run_s"], engine_steps=engines)
            if not learn:
                refs = [tnn_engine.reference_outputs(
                    tuple(p.cpu() for p in p_ff), cpu_net, s)
                    for s in population]
                if not all(np.array_equal(a, b)
                           for a, b in zip(results, refs)):
                    raise AssertionError(f"{name}: a request differs from "
                                         f"the CPU closed-form reference")
                return dict(fields, bit_exact=True)
            for key in ("weight_drift_l0", "weight_drift_l1"):
                fields[key] = st[key]
            if n_slots == LEARN_SLOTS:
                off = last["learn_off"][0]
                first = [r[0] for r in results[:n_slots]]
                if not all(np.array_equal(a, b[0])
                           for a, b in zip(first, off)):
                    raise AssertionError(f"{name}: first step's outputs "
                                         f"differ from learning off")
                if backend == "fused_compact":
                    want_out, want_p = last["learn_every1"]
                else:
                    want_out, want_p = manual_learning_run(
                        dev, pop, ff, p_ff, every, seed)
                if not all(np.array_equal(a, b)
                           for a, b in zip(results, want_out)) or not all(
                        torch.equal(a, b) for a, b in zip(params, want_p)):
                    raise AssertionError(
                        f"{name}: outputs or weights differ from a manual "
                        f"network.step loop on the card")
                fields["replay_bit_exact"] = True
            if seed is not None:
                if len(seeded) < 2 or not all(
                        torch.equal(a, b) for a, b in zip(seeded[-1],
                                                          seeded[-2])):
                    raise AssertionError(f"{name}: two seeded runs learned "
                                         f"different weights")
                fields["seeded_runs_equal"] = len(seeded)
            if name in ("learn_every1", "learn_every1_64"):
                first_batch = torch.from_numpy(np.stack(
                    [s[0] for s in population[:n_slots]]))
                fields["one_step_vs_cpu"] = check_one_step(dev, ff, p_ff,
                                                           first_batch)
            if backend == "auto" and seed is None:
                cpu = engine(n_slots, "closed_form", "cpu",
                             tuple(p.cpu() for p in p_ff), cpu_net, **kw)
                cpu_results = cpu.serve(population)
                fields["whole_run_vs_cpu"] = dict(
                    weight_agreement(cpu.params, params),
                    outputs_differ=sum(
                        int((a != b).any(axis=(1, 2)).sum())
                        for a, b in zip(results, cpu_results)),
                    outputs=sum(r.shape[0] for r in results))
            return fields

        launches = (lambda st: 2 * int(st["n_steps"]))
        return Path(name, kernel, run, check, launches=launches)

    return [learn_path("learn_off", pop, LEARN_SLOTS),
            learn_path("learn_every1", pop, LEARN_SLOTS, every=1),
            learn_path("learn_every4", pop, LEARN_SLOTS, every=4),
            learn_path("learn_seeded", pop, LEARN_SLOTS, every=1, seed=0),
            learn_path("learn_every1_compact", pop, LEARN_SLOTS,
                       backend="fused_compact", every=1),
            learn_path("learn_every1_64", streams, N_SLOTS, every=1)]


def one_shot_failure(at_step: int):
    """A ``serve_resilient`` failure injector: one ``WorkerFailure`` at the
    first step whose ``step_id`` is at least ``at_step``."""
    fired: List[int] = []

    def injector(step_id: int) -> None:
        if step_id >= at_step and not fired:
            fired.append(step_id)
            raise fault_tolerance.WorkerFailure(1, "(injected)")

    return injector


def same_outputs(got, want) -> bool:
    return len(got) == len(want) and all(
        a is not None and np.array_equal(a, b) for a, b in zip(got, want))


def same_weights(got, want) -> bool:
    return all(torch.equal(a, b) for a, b in zip(got, want))


def snapshot(directory, step, like):
    """The snapshot at ``step`` under ``directory``, its weights on the
    device of ``like``'s; raises when it is not on disk."""
    return ckpt.restore_checkpoint(
        directory, {"params": tuple(like), "counters": np.zeros(2, np.int32)},
        step=step)


def durability_paths(dev, streams, ff, p_ff, served, root) -> List[Path]:
    """Durability at the served network's full width, every path on the
    RNL layer kernel, two launches a step, replayed steps included.

    - ``resilient_serve``: ``serve_resilient`` over a 64-slot ``auto``
      engine and the 256 clients, snapshots every ``SERVE_SNAPSHOT_EVERY``
      steps (synchronous), one ``WorkerFailure`` at the first step_id >=
      ``SERVE_FAIL_AT``. Held: every output equals the ``auto`` path's;
      the restore went to the latest snapshot before the failure; exactly
      the streams an uninterrupted run retires after it were resubmitted;
      one restore; the monitor was beaten.
    - ``resilient_learn`` / ``resilient_learn_seeded``: the learning
      workload (4 slots, STDP every step; the second with ``stdp_seed=0``)
      with async snapshots every ``LEARN_SNAPSHOT_EVERY`` steps and a
      failure at step_id ``LEARN_FAIL_AT``. Held: the streams committed by
      the restored snapshot equal the ``learn_every1`` / ``learn_seeded``
      path's; that snapshot equals a manual ``network.step`` loop's
      weights after as many steps (the async save is step-consistent);
      the final weights, update count and replayed outputs equal a fresh
      engine's built from the snapshot that serves the resubmitted
      streams.
    - ``resume_learn``: ``TNNEngine(..., resume=True)`` on the last
      ``resilient_learn`` directory, then ``RESUME_CLIENTS`` more clients.
      Held: it resumed at the latest snapshot's step with its weights, on
      the card, one restore; what it then served and learned equals a
      fresh engine's built from that snapshot.
    - ``async_serve``: ``AsyncTNNEngine`` over a 64-slot ``auto`` engine,
      the 256 clients submitted at once through ``asyncio.gather``. Held:
      every output equals the ``auto`` path's.

    Each snapshot is read back from disk after ``checkpoint_wait()``, so an
    error in the async writer fails the path."""
    pop = learn_population(streams, LEARN_CLIENTS, LEARN_CYCLES)
    dirs: Dict[str, str] = {}
    launches = (lambda st: 2 * int(st["n_steps"]))

    def engine(n_slots, resume=False, **kw):
        return tnn_engine.TNNEngine(p_ff, ff, tnn_engine.TNNServeConfig(
            n_slots=n_slots, **kw), device=dev, resume=resume)

    def retirement_steps(population, n_slots):
        """The step_id after which each stream retires in an uninterrupted
        run: a snapshot at step s commits the streams retired at or before
        s."""
        eng = engine(n_slots)
        reqs = [eng.submit(s) for s in population]
        at: Dict[int, int] = {}
        while eng.pool.has_work:
            for req in eng.step():
                at[req.req_id] = eng.step_id
        return [at[r.req_id] for r in reqs]

    def check_engine_steps(name, st):
        engines = engine_steps(st)
        if engines != {"fused": int(st["n_steps"])}:
            raise AssertionError(f"{name}: engines {engines}, expected every "
                                 f"step on fused")
        return engines

    def resilient_check(name, report, st, restored, retired_at, directory,
                        every):
        """The checks every resilient run shares; returns its fields."""
        resub = [i for i, s in enumerate(retired_at) if s > restored]
        if (report["restarts"] != 1 or report["failed_hosts"] != [1]
                or report["restored_steps"] != [restored]
                or report["resubmitted"] != [resub]):
            raise AssertionError(f"{name}: report {report}, expected one "
                                 f"restore to step {restored} resubmitting "
                                 f"{len(resub)} streams")
        if int(st["n_restores"]) != 1 or int(st["n_snapshots"]) < 1:
            raise AssertionError(f"{name}: {st['n_restores']} restores, "
                                 f"{st['n_snapshots']} snapshots")
        last = int(st["step_id"]) // every * every
        if ckpt.latest_step(directory) != last:
            raise AssertionError(f"{name}: latest snapshot on disk "
                                 f"{ckpt.latest_step(directory)}, expected "
                                 f"{last}")
        return dict(requests=len(retired_at), steps=int(st["n_steps"]),
                    step_id=int(st["step_id"]),
                    snapshots=int(st["n_snapshots"]),
                    restored_step=restored, resubmitted=len(resub),
                    engine_steps=check_engine_steps(name, st),
                    run_s=st["run_s"])

    def serve_run():
        directory = tempfile.mkdtemp(dir=root)
        eng = engine(N_SLOTS, checkpoint_dir=directory,
                     checkpoint_every=SERVE_SNAPSHOT_EVERY,
                     checkpoint_async=False)
        mon = fault_tolerance.HeartbeatMonitor(1)
        results, report = tnn_engine.serve_resilient(
            eng, streams, failure_injector=one_shot_failure(SERVE_FAIL_AT),
            monitor=mon)
        return (results, report, mon, directory), eng.stats()

    def serve_check(out, st):
        results, report, mon, directory = out
        restored = SERVE_FAIL_AT // SERVE_SNAPSHOT_EVERY * SERVE_SNAPSHOT_EVERY
        fields = resilient_check("resilient_serve", report, st, restored,
                                 retirement_steps(streams, N_SLOTS),
                                 directory, SERVE_SNAPSHOT_EVERY)
        if not same_outputs(results, served["auto"]):
            raise AssertionError("resilient_serve: outputs differ from the "
                                 "auto path's")
        if not mon.hosts[0].step_times:
            raise AssertionError("resilient_serve: the monitor was not "
                                 "beaten")
        return dict(fields, monitor_beats=len(mon.hosts[0].step_times),
                    bit_exact=True)

    def learn_path(name, base, seed):
        kw = dict(learn=True, stdp_every=1, stdp_seed=seed)

        def run():
            directory = dirs[name] = tempfile.mkdtemp(dir=root)
            eng = engine(LEARN_SLOTS, checkpoint_dir=directory,
                         checkpoint_every=LEARN_SNAPSHOT_EVERY,
                         checkpoint_async=True, **kw)
            results, report = tnn_engine.serve_resilient(
                eng, pop, failure_injector=one_shot_failure(LEARN_FAIL_AT))
            return (results, report, eng.params, directory), eng.stats()

        def check(out, st):
            results, report, params, directory = out
            restored = LEARN_FAIL_AT // LEARN_SNAPSHOT_EVERY \
                * LEARN_SNAPSHOT_EVERY
            retired_at = [(i // LEARN_SLOTS + 1) * LEARN_CYCLES
                          for i in range(len(pop))]
            fields = resilient_check(name, report, st, restored, retired_at,
                                     directory, LEARN_SNAPSHOT_EVERY)
            committed = [i for i, s in enumerate(retired_at)
                         if s <= restored]
            if not same_outputs([results[i] for i in committed],
                                [served[base][0][i] for i in committed]):
                raise AssertionError(f"{name}: a committed stream differs "
                                     f"from the {base} path's")
            snap = snapshot(directory, restored, p_ff)
            _, want_p = manual_learning_run(dev, pop, ff, p_ff, 1, seed,
                                            n_steps=restored)
            counters = [int(c) for c in snap["counters"]]
            if counters != [restored, restored] or not same_weights(
                    snap["params"], want_p):
                raise AssertionError(f"{name}: the step-{restored} snapshot "
                                     f"(counters {counters}) differs from "
                                     f"a manual network.step loop")
            fresh = tnn_engine.TNNEngine(
                snap["params"], ff, tnn_engine.TNNServeConfig(
                    n_slots=LEARN_SLOTS, **kw), device=dev)
            fresh.step_id, fresh.n_stdp_updates = counters
            resub = report["resubmitted"][0]
            replayed = fresh.serve([pop[i] for i in resub])
            if not same_weights(params, fresh.params) \
                    or int(st["n_stdp_updates"]) != fresh.n_stdp_updates \
                    or not same_outputs([results[i] for i in resub],
                                        replayed):
                raise AssertionError(f"{name}: weights, updates or replayed "
                                     f"outputs differ from a fresh engine "
                                     f"built from the snapshot")
            return dict(fields, committed=len(committed),
                        stdp_updates=int(st["n_stdp_updates"]),
                        snapshot_equals_manual_loop=True,
                        replay_bit_exact=True)

        return Path(name, "rnl_fire_times_layer", run, check,
                    launches=launches)

    def resume_run():
        directory = dirs["resilient_learn"]
        latest = ckpt.latest_step(directory)
        eng = engine(LEARN_SLOTS, resume=True, learn=True,
                     checkpoint_dir=directory,
                     checkpoint_every=LEARN_SNAPSHOT_EVERY)
        at = dict(latest=latest, step_id=eng.step_id,
                  updates=eng.n_stdp_updates, restores=eng.n_restores,
                  params=tuple(p.clone() for p in eng.params))
        results = eng.serve(pop[:RESUME_CLIENTS])
        eng.checkpoint_wait()
        return (at, results, eng.params, directory), eng.stats()

    def resume_check(out, st):
        at, results, params, directory = out
        snap = snapshot(directory, at["latest"], p_ff)
        counters = [int(c) for c in snap["counters"]]
        if (at["step_id"] != at["latest"] or at["restores"] != 1
                or at["updates"] != counters[1]
                or not same_weights(at["params"], snap["params"])
                or any(p.device.type != "cuda" for p in at["params"])):
            raise AssertionError(f"resume_learn: resumed at step "
                                 f"{at['step_id']} with {at['restores']} "
                                 f"restores, expected the snapshot at "
                                 f"{at['latest']} on the card")
        fresh = tnn_engine.TNNEngine(snap["params"], ff,
                                     tnn_engine.TNNServeConfig(
                                         n_slots=LEARN_SLOTS, learn=True),
                                     device=dev)
        fresh.step_id, fresh.n_stdp_updates = counters
        if not same_outputs(results, fresh.serve(pop[:RESUME_CLIENTS])) \
                or not same_weights(params, fresh.params):
            raise AssertionError("resume_learn: outputs or weights differ "
                                 "from a fresh engine built from the "
                                 "snapshot")
        return dict(resumed_step=at["step_id"], requests=RESUME_CLIENTS,
                    steps=int(st["n_steps"]),
                    engine_steps=check_engine_steps("resume_learn", st),
                    weights_on="cuda", bit_exact=True)

    def async_run():
        eng = engine(N_SLOTS)
        front = tnn_engine.AsyncTNNEngine(eng)

        async def clients():
            return await asyncio.gather(*[front.submit(s) for s in streams])

        return asyncio.run(clients()), eng.stats()

    def async_check(results, st):
        if not same_outputs(results, served["auto"]):
            raise AssertionError("async_serve: outputs differ from the auto "
                                 "path's")
        return dict(requests=len(streams), steps=int(st["n_steps"]),
                    volleys_per_s=st.get("volleys_per_s"),
                    engine_steps=check_engine_steps("async_serve", st),
                    bit_exact=True)

    return [Path("resilient_serve", "rnl_fire_times_layer", serve_run,
                 serve_check, launches=launches),
            learn_path("resilient_learn", "learn_every1", None),
            learn_path("resilient_learn_seeded", "learn_seeded", 0),
            Path("resume_learn", "rnl_fire_times_layer", resume_run,
                 resume_check, launches=launches),
            Path("async_serve", "rnl_fire_times_layer", async_run,
                 async_check, launches=launches)]


def column_paths(dev) -> List[Path]:
    """The clustering example's stream (600 volleys over 16 lines, 3
    classes, from its numpy seed) through ``column.train_column`` with 3
    neurons, Catwalk (threshold 12, k = 2) and compact PC (threshold 18):
    one single-bank kernel launch a volley. Held: final weights and winners
    bit-exact against the same training on the CPU (B = 1: no reduction).
    Reported: purity by thirds of the stream."""
    volleys, labels = clustering.make_stream(np.random.default_rng(42),
                                             CLUSTER_VOLLEYS)
    x = torch.from_numpy(volleys)

    def column_path(dendrite, thr, k):
        cfg = column.ColumnConfig(n_inputs=16, n_neurons=3, threshold=thr,
                                  t_steps=16, dendrite=dendrite, k=k,
                                  stdp=clustering.stdp_config())
        w0 = column.init_column(torch.Generator().manual_seed(0), cfg, dev)
        x_dev = x.to(dev)

        def run():
            return column.train_column(w0, x_dev, cfg), None

        def check(outputs, _):
            w, winners = outputs
            want_w, want_win = column.train_column(
                w0.cpu(), x, dataclasses.replace(cfg, backend="closed_form"))
            if winners.dtype != torch.int32 \
                    or not torch.equal(winners.cpu(), want_win) \
                    or not torch.equal(w.cpu(), want_w):
                raise AssertionError(f"train_column_{dendrite}: weights or "
                                     f"winners differ from the CPU run")
            m = CLUSTER_VOLLEYS
            thirds = [float(column.cluster_purity(
                want_win[lo:hi], torch.from_numpy(labels[lo:hi]), 3, 3))
                for lo, hi in ((0, m // 3), (m // 3, 2 * m // 3),
                               (2 * m // 3, m))]
            return dict(volleys=m, neurons=3, purity_by_thirds=thirds,
                        bit_exact=True)

        return Path(f"train_column_{dendrite}", "rnl_fire_times", run, check,
                    launches=CLUSTER_VOLLEYS)

    return [column_path(*d) for d in clustering.DENDRITES]


def lm_prompts() -> List[np.ndarray]:
    """N_PROMPTS prompts of 16-128 tokens from ``tokenizer.encode`` (BOS
    plus 15-127 bytes of lowercase text)."""
    rng = np.random.default_rng(6)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz     "))
    return [tokenizer.encode("".join(rng.choice(letters,
                                                int(rng.integers(15, 128)))))
            for _ in range(N_PROMPTS)]


def requests(vocab: int, n: int, max_prompt: int, seed: int
             ) -> List[np.ndarray]:
    """``n`` prompts of 1-``max_prompt`` random in-vocab ids, drawn as the
    request population of benchmarks/bench_serve_lm.py (``_population``)
    draws them; the MoE path serves that population, halved."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(1, max_prompt + 1, size=n)
    return [rng.randint(3, vocab, (int(k),)).astype(np.int32)
            for k in lengths]


def frontend(cfg, b: int, n: int, seed: int) -> np.ndarray:
    """``b`` x ``n`` precomputed patch or frame embeddings of the config's
    width (float32, a numpy seed): the frontends are stubs in the
    reference too."""
    return np.random.default_rng(seed).standard_normal(
        (b, n, cfg.frontend.d_embed), dtype=np.float32)


def _prefill_check(name, cfg, tokens, out, **fields) -> Dict[str, Any]:
    logits, aux = out
    want = (tokens.shape[0], 1, cfg.vocab_size)
    if tuple(logits.shape) != want or logits.dtype != torch.bfloat16 \
            or not bool(torch.isfinite(logits).all()) \
            or not bool(torch.isfinite(aux)):
        raise AssertionError(f"{name}: logits {tuple(logits.shape)} "
                             f"{logits.dtype}, expected finite {want}")
    return dict(arch=cfg.name, layers=cfg.n_layers, dtype=cfg.dtype,
                batch=int(tokens.shape[0]), seq=int(tokens.shape[1]),
                finite=True, **fields)


def _generate_check(name, cfg, prompts, new_tokens, outs, st):
    if len(outs) != len(prompts) or any(
            not 1 <= len(o) <= new_tokens or o.min() < 0
            or o.max() >= cfg.vocab_size for o in outs):
        raise AssertionError(f"{name}: outputs out of range")
    new = sum(len(o) for o in outs)
    return dict(arch=cfg.name, layers=cfg.n_layers, dtype=cfg.dtype,
                requests=len(prompts),
                prompt_tokens=[len(p) for p in prompts],
                new_tokens=new, steps=st["steps"],
                tokens_per_s=new / st["wall_s"],
                steps_per_s=st["steps"] / st["wall_s"])


def _timed_generate(eng, *args, **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = eng.generate(*args, **kw)
    wall_s = time.perf_counter() - t0
    return outs, dict(steps=eng.n_steps, wall_s=wall_s)


def lm_paths(dev, cfg, params, tokens, prompts) -> List[Path]:
    """mamba2-780m inference at full width and depth: the prefill forward
    on ``tokens`` (B sequences of L tokens, ``logits_mode="last"``), one
    SSD scan launch per layer, and ``Engine.generate`` on ``prompts``
    (greedy), whose decode is the one-token recurrence and launches no
    kernel."""
    def prefill_run():
        return lm.forward(params, cfg, tokens, logits_mode="last"), None

    def prefill_check(out, _):
        return _prefill_check("lm_prefill", cfg, tokens, out)

    def generate_run():
        return _timed_generate(Engine(params, cfg, ServeConfig(), device=dev),
                               prompts, NEW_TOKENS)

    def generate_check(outs, st):
        return _generate_check("lm_generate", cfg, prompts, NEW_TOKENS, outs,
                               st)

    return [Path("lm_prefill", "ssd_scan", prefill_run, prefill_check,
                 launches=cfg.n_layers),
            Path("lm_generate", None, generate_run, generate_check)]


def moe_engine(dev, cfg, params) -> Engine:
    return Engine(params, cfg, ServeConfig(
        max_len=MOE_MAX_PROMPT + MOE_NEW_TOKENS + 2), device=dev)


def moe_paths(dev, cfg, params, tokens, prompts) -> List[Path]:
    """deepseek-v2-lite-16b inference at full width and depth: the prefill
    forward on ``tokens`` (``logits_mode="last"``; one gate launch per
    layer) and ``Engine.serve`` of ``prompts`` through MOE_SLOTS slots,
    continuous and then wave (one gate launch per layer per decode step).
    The serve check holds both schedules' tokens equal, and each request's
    tokens equal to its own ``serve([p], n_slots=MOE_SLOTS)``: the same
    batch shape, so the card's products round alike (a 1-slot serve picks
    other GEMM kernels; for the first MOE_ONE_SLOT requests its agreement
    is reported, not held)."""
    def prefill_run():
        logits, aux = lm.forward(params, cfg, tokens, logits_mode="last")
        return (logits, aux), None

    def prefill_check(out, _):
        return _prefill_check("moe_prefill", cfg, tokens, out,
                              aux_loss=float(out[1]))

    def serve_run():
        eng = moe_engine(dev, cfg, params)
        outs, stats = {}, {}
        for mode in ("continuous", "wave"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[mode] = eng.serve(prompts, MOE_NEW_TOKENS, n_slots=MOE_SLOTS,
                                   continuous=mode == "continuous")
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            new = sum(len(o) for o in outs[mode])
            stats[mode] = dict(steps=eng.n_steps, wall_s=wall_s,
                               new_tokens=new, tokens_per_s=new / wall_s,
                               steps_per_s=eng.n_steps / wall_s)
        return outs, stats

    def serve_check(outs, st):
        eng = moe_engine(dev, cfg, params)
        alone = [eng.serve([p], MOE_NEW_TOKENS, n_slots=MOE_SLOTS)[0]
                 for p in prompts]
        one_slot = [eng.serve([p], MOE_NEW_TOKENS)[0]
                    for p in prompts[:MOE_ONE_SLOT]]
        for mode, got in outs.items():
            for i, (o, a) in enumerate(zip(got, alone)):
                if not 1 <= len(o) <= MOE_NEW_TOKENS or o.min() < 0 \
                        or o.max() >= cfg.vocab_size:
                    raise AssertionError(f"moe_serve {mode}: request {i}'s "
                                         f"tokens out of range")
                if not np.array_equal(o, a):
                    raise AssertionError(
                        f"moe_serve {mode}: request {i}'s tokens differ from "
                        f"its own serve([p], n_slots={MOE_SLOTS})")
        if st["continuous"]["steps"] > st["wave"]["steps"]:
            raise AssertionError(f"moe_serve: continuous took "
                                 f"{st['continuous']['steps']} steps, wave "
                                 f"{st['wave']['steps']}")
        return dict(arch=cfg.name, layers=cfg.n_layers, dtype=cfg.dtype,
                    requests=len(prompts), slots=MOE_SLOTS,
                    prompt_tokens=[len(p) for p in prompts],
                    max_new_tokens=MOE_NEW_TOKENS, **st,
                    equal_to_own_serve=len(prompts),
                    one_slot_serves=len(one_slot),
                    equal_to_one_slot_serve=sum(
                        bool(np.array_equal(o, a))
                        for o, a in zip(outs["continuous"], one_slot)))

    def serve_launches(st):
        return cfg.n_layers * (st["continuous"]["steps"]
                               + st["wave"]["steps"])

    return [Path("moe_prefill", "moe_gate_topk", prefill_run, prefill_check,
                 launches=cfg.n_layers),
            Path("moe_serve", "moe_gate_topk", serve_run, serve_check,
                 launches=serve_launches)]


def vlm_paths(dev, cfg, params, tokens, patches, prompts) -> List[Path]:
    """phi-3-vision-4.2b at full width and depth: the prefill forward on
    ``tokens`` after the ``patches`` prefix (``logits_mode="last"``; the
    check also runs ``"all"``, whose logits leave the prefix out), and
    ``Engine.serve`` of ``prompts`` through VLM_SLOTS slots, continuous:
    each request's tokens must equal its own ``serve([p],
    n_slots=VLM_SLOTS)`` (the same batch shape, so the card's products
    round alike). The prefill launches the fused attention kernel once a
    layer; the serve, whose prompts go through the cached decode, never."""
    def prefill_run():
        return lm.forward(params, cfg, tokens, patches=patches,
                          logits_mode="last"), None

    def prefill_check(out, _):
        every, _ = lm.forward(params, cfg, tokens, patches=patches)
        want = (tokens.shape[0], tokens.shape[1], cfg.vocab_size)
        if tuple(every.shape) != want \
                or not bool(torch.isfinite(every).all()):
            raise AssertionError(f"vlm_prefill: logits_mode='all' gave "
                                 f"{tuple(every.shape)}, expected finite "
                                 f"{want} (the prefix left out)")
        return _prefill_check(
            "vlm_prefill", cfg, tokens, out, patches=int(patches.shape[1]),
            all_logits=list(every.shape),
            last_vs_all_over_scale=_over_scale(out[0][:, 0],
                                               every[:, -1]))

    def engine():
        return Engine(params, cfg, ServeConfig(
            max_len=VLM_MAX_PROMPT + VLM_NEW_TOKENS + 2), device=dev)

    def serve_run():
        eng = engine()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = eng.serve(prompts, VLM_NEW_TOKENS, n_slots=VLM_SLOTS)
        torch.cuda.synchronize()
        return outs, dict(steps=eng.n_steps, wall_s=time.perf_counter() - t0)

    def serve_check(outs, st):
        eng = engine()
        for i, (o, p) in enumerate(zip(outs, prompts)):
            alone = eng.serve([p], VLM_NEW_TOKENS, n_slots=VLM_SLOTS)[0]
            if not np.array_equal(o, alone):
                raise AssertionError(
                    f"vlm_serve: request {i}'s tokens differ from its own "
                    f"serve([p], n_slots={VLM_SLOTS})")
        return dict(_generate_check("vlm_serve", cfg, prompts,
                                    VLM_NEW_TOKENS, outs, st),
                    slots=VLM_SLOTS, equal_to_own_serve=len(prompts))

    return [Path("vlm_prefill", None, prefill_run, prefill_check,
                 attention=gqa_calls(cfg)),
            Path("vlm_serve", None, serve_run, serve_check)]


def audio_paths(dev, cfg, params, tokens, frames, prompts) -> List[Path]:
    """seamless-m4t-medium at full width and depth: the prefill forward on
    ``tokens`` with ``frames`` (the 12-layer encoder, then the decoder
    cross-attending to its output; ``logits_mode="last"``), and
    ``Engine.generate(prompts, frames=)`` on the static path (the encoder
    once, in ``init_serve_state``; each decode step recomputes the cross
    K/V of the 1,024 frames in every layer, as the reference does). The
    fused attention kernel: the prefill's every encoder layer and its
    decoder's self- and cross-attention; the generation's encoder layers
    once and each decode step's cross-attention (its self-attention reads
    the cache)."""
    def prefill_run():
        return lm.forward(params, cfg, tokens, frames=frames,
                          logits_mode="last"), None

    def prefill_check(out, _):
        return _prefill_check("audio_prefill", cfg, tokens, out,
                              frames=int(frames.shape[1]),
                              encoder_layers=cfg.encdec.n_encoder_layers)

    def generate_run():
        eng = Engine(params, cfg, ServeConfig(
            max_len=AUDIO_MAX_PROMPT + AUDIO_NEW_TOKENS + 2), device=dev)
        return _timed_generate(eng, prompts, AUDIO_NEW_TOKENS, frames=frames)

    def generate_check(outs, st):
        return _generate_check("audio_generate", cfg, prompts,
                               AUDIO_NEW_TOKENS, outs, st)

    enc, cross = (cfg.encdec.n_encoder_layers, cfg.n_layers) \
        if gqa_calls(cfg) else (0, 0)
    return [Path("audio_prefill", None, prefill_run, prefill_check,
                 attention=gqa_calls(cfg)),
            Path("audio_generate", None, generate_run, generate_check,
                 attention=lambda st: enc + cross * st["steps"])]


def hybrid_paths(dev, cfg, params, tokens, prompts) -> List[Path]:
    """zamba2-1.2b at full width and depth: the prefill forward on
    ``tokens`` (``logits_mode="last"``; one SSD launch in each of the 38
    layers, the shared attention block after every 6th: one fused
    attention launch a site), and the static
    ``Engine.generate`` on ``prompts``, whose decode is the one-token
    recurrence and the shared block over each site's cache: no launch."""
    def prefill_run():
        return lm.forward(params, cfg, tokens, logits_mode="last"), None

    def prefill_check(out, _):
        return _prefill_check("hybrid_prefill", cfg, tokens, out,
                              period=cfg.hybrid.period,
                              sites=cfg.n_layers // cfg.hybrid.period)

    def generate_run():
        eng = Engine(params, cfg, ServeConfig(), device=dev)
        return _timed_generate(eng, prompts, HYBRID_NEW_TOKENS)

    def generate_check(outs, st):
        return _generate_check("hybrid_generate", cfg, prompts,
                               HYBRID_NEW_TOKENS, outs, st)

    return [Path("hybrid_prefill", "ssd_scan", prefill_run, prefill_check,
                 launches=cfg.n_layers, attention=gqa_calls(cfg)),
            Path("hybrid_generate", None, generate_run, generate_check)]


def capture(run, ssd_copies: Optional[int] = None,
            result: Optional[list] = None) -> List[Dict[str, Any]]:
    """Drives ``run()`` with the three RNL wrappers, the unary top-k entry,
    the gate-level entry, the SSD scan entry and the MoE gate entry spied
    on. Returns, for each
    distinct call (wrapper, operand shapes, options or network) in
    first-call order, its number of calls and a copy of the operands of its
    busiest call — the one with the most in-cycle spikes (hot bits for
    unary top-k), so that a pipeline's all-silent fill and drain ticks do
    not stand for the path; for the SSD scan, a copy of the operands of
    every call (of the first ``ssd_copies`` calls, when given); for the
    gate, of the first call. ``run()``'s return value is appended to
    ``result`` when given."""
    cases: Dict[tuple, Dict[str, Any]] = {}
    originals = {name: getattr(rn, name) for name in RNL_WRAPPERS}
    topk = ut._unary_topk
    trace = ut.gate_level_trace
    ssd = ss._ssd_scan
    gate = mg._moe_gate

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

    def spy_trace(times, weights, units, n, k, t_steps):
        units = tuple(tuple(u) for u in units)
        key = ("gate_level_trace", tuple(times.shape), tuple(weights.shape),
               units, n, k, t_steps)
        case = cases.setdefault(key, dict(wrapper="gate_level_trace",
                                          units=units, n=n, k=k,
                                          t_steps=t_steps, calls=0,
                                          spikes=-1))
        case["calls"] += 1
        spikes = int((times < t_steps).sum())
        if spikes > case["spikes"]:
            case.update(times=times.clone(), weights=weights.clone(),
                        spikes=spikes)
        return trace(times, weights, units, n, k, t_steps)

    def spy_ssd(u, log_decay, b, c, chunk, heads):
        key = ("ssd_scan", tuple(u.shape), tuple(b.shape), str(u.dtype),
               chunk, heads)
        case = cases.setdefault(key, dict(wrapper="ssd_scan", chunk=chunk,
                                          heads=heads, calls=0, operands=[]))
        case["calls"] += 1
        if ssd_copies is None or len(case["operands"]) < ssd_copies:
            case["operands"].append(tuple(t.clone()
                                          for t in (u, log_decay, b, c)))
        return ssd(u, log_decay, b, c, chunk, heads)

    def spy_gate(logits, k, renorm):
        key = ("moe_gate_topk", tuple(logits.shape), k, renorm)
        case = cases.setdefault(key, dict(wrapper="moe_gate_topk", k=k,
                                          renorm=renorm, calls=0))
        case["calls"] += 1
        case.setdefault("logits", logits.clone())
        return gate(logits, k, renorm)

    for name, fn in originals.items():
        setattr(rn, name, spy(name, fn))
    ut._unary_topk = spy_topk
    ut.gate_level_trace = spy_trace
    ss._ssd_scan = spy_ssd
    mg._moe_gate = spy_gate
    try:
        out = run()
        if result is not None:
            result.append(out)
    finally:
        for name, fn in originals.items():
            setattr(rn, name, fn)
        ut._unary_topk = topk
        ut.gate_level_trace = trace
        ss._ssd_scan = ssd
        mg._moe_gate = gate
    return list(cases.values())


def synthetic_cases(dev):
    """(variant, label, times, weights, kwargs) at the repository's
    benchmark shapes and edge cases, all on ``dev``: the sizes past the
    launchers' old caps (n = 2,048 at (B, Q) = (128, 1) and (256, 64),
    layer and bank, T = 64 and T = 1 with threshold <= 0, clip on and off;
    compact over >= 1,024 active lines at Q = 1, B = 256; a layer call of
    262,148 volleys at Q = 32), bench_shard's full size (C=64, B=32, rf=16,
    Q=16, T=64), bench_sparsity's (B=Q=n=T=64, compact at density 0.1),
    ragged B and Q with negative weights and spikes at or past the cycle
    end, threshold <= 0, k set and None."""
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
    # sizes the launchers refused before the sweep kernel's redesign:
    # shared memory grew with n (caps of 450 lines at Q = 1, B >= 128;
    # 1,614 at Q >= 32; 454 compacted lines at Q = 1) and a grid dimension
    # held at most 65,535 volley tiles (262,140 volleys at Q >= 32)
    cap1_x, cap1_w = volleys((1, 128, 2048), 64, 0.5), weights((1, 1, 2048))
    cap64_x = volleys((1, 256, 2048), 64, 0.5)
    cap64_w = weights((1, 64, 2048))
    cap = dict(t_steps=64, threshold=2000, k=40)
    cap_comp = compaction.compact_volleys(volleys((256, 2400), 64, 0.5), 64)
    cap_c = cap_comp.times.contiguous()
    cap_cw = compaction.gather_weights(weights((1, 2400)),
                                       cap_comp.line_index).contiguous()
    grid_x, grid_w = volleys((1, 262_148, 4), 8, 0.6), weights((1, 32, 4))
    grid = dict(t_steps=8, threshold=3, k=1)
    tick1 = dict(t_steps=1, threshold=0, k=2)
    return [
        ("layer", "cap_n2048_b128_q1", cap1_x, cap1_w, cap),
        ("layer+clip", "cap_n2048_b128_q1", cap1_x, cap1_w, {**cap, **clip}),
        ("layer", "cap_n2048_b256_q64", cap64_x, cap64_w, cap),
        ("layer+clip", "cap_n2048_b256_q64", cap64_x, cap64_w,
         {**cap, **clip}),
        ("layer", "cap_n2048_b256_q64_t1_threshold_0", cap64_x, cap64_w,
         tick1),
        ("bank", "cap_n2048_b128_q1", cap1_x[0], cap1_w[0], cap),
        ("bank", "cap_n2048_b256_q64_k_none", cap64_x[0], cap64_w[0],
         {**cap, "k": None, "threshold": 1500}),
        ("bank+clip", "cap_n2048_b256_q64_t1_threshold_neg", cap64_x[0],
         cap64_w[0], {**tick1, "threshold": -2, **clip}),
        ("compact", f"cap_s{cap_c.shape[1]}_b256_q1", cap_c, cap_cw,
         dict(t_steps=64, threshold=300, k=20)),
        ("layer", "grid_262148_volleys_q32", grid_x, grid_w, grid),
        ("layer+clip", "grid_262148_volleys_q32", grid_x, grid_w,
         {**grid, **clip}),
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


def check_and_time(variant, label, x, w, kw, timed=True,
                   **extra) -> Dict[str, Any]:
    """One launch variant against its plain version on the same inputs on
    the card (bit-exact, or raise), then, when ``timed``, its times and
    bound."""
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
    if not timed:
        row = dict(variant=variant, shape=label, **extra,
                   times=list(x.shape), weights=list(w.shape),
                   max_abs_err=err, timed=False)
        emit("kernels", **row)
        return row
    call_ms = time_ms(lambda: fn(x, w, **kw))
    ms, per_call = kernel_ms(lambda: fn(x, w, **kw))
    plain_ms = time_ms(lambda: plain(x, w, **kw), reps=5, warmup=1)
    bound, bound_by = bound_ms(x, w, got_t[0],
                               got_t[1] if len(got_t) > 1 else None,
                               kw["t_steps"], kw["threshold"])
    row = dict(variant=variant, shape=label, **extra, times=list(x.shape),
               weights=list(w.shape),
               options={k: v for k, v in kw.items() if k != "with_clip"},
               max_abs_err=err, ms=call_ms if ms is None else ms,
               ms_source="cuda_events" if ms is None else "profiler",
               kernels_per_call=per_call,
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
        ms, per_call = kernel_ms(fn, key="unary_topk_kernel")
        rows = bits.numel() // n
        bound, bound_by = topk_bound_ms(rows, n, len(units),
                                        got.numel() * got.element_size())
        row.update(ms=call_ms if ms is None else ms,
                   ms_source="cuda_events" if ms is None else "profiler",
                   kernels_per_call=per_call,
                   call_ms=call_ms,
                   plain_ms=time_ms(plain, reps=5, warmup=1),
                   bound_ms=bound, bound_by=bound_by,
                   library_ms=time_ms(lambda: bits.sum(
                       -1, dtype=torch.int32).clamp_(max=k)))
    emit("kernels", **row)
    return row


def gate_trace_bound_ms(times, weights, t_steps, n_units):
    """Least time the card could take for one gate-level call: the larger
    of the bytes it must move (the times and weights read once, the
    potential trace and the clip counts written once) over the memory
    rate, and, for every pair's every 32-tick word, 1 int32 operation a
    wire (its ramp word) and 2 a CAS unit (AND, OR) over the int32 ALU
    rate; returns ``(ms, "bytes" | "operations")``."""
    pairs = times.numel() // times.shape[-1] * weights.shape[-2]
    nbytes = 4 * (times.numel() + weights.numel() + pairs * (t_steps + 1))
    ops = -(-t_steps // 32) * pairs * (times.shape[-1] + 2 * n_units)
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return 1e3 * max(by_bytes, by_ops), \
        ("bytes" if by_bytes > by_ops else "operations")


def check_gate_trace(label, times, weights, units, n, k, t_steps, *,
                     timed=True, **extra) -> Dict[str, Any]:
    """One gate-level call against its plain version (the bit-plane
    composition) on the same inputs on the card (potential and clip
    counts bit-exact, or raise); when ``timed``, its times and its bound.
    No single PyTorch call computes it: ``library_ms`` is None."""
    def fn():
        return ut.gate_level_trace(times, weights, units, n, k, t_steps)

    def plain():
        return ut.gate_level_trace_plain(times, weights, units, n, k,
                                         t_steps)

    got, want = fn(), plain()
    torch.cuda.synchronize()
    err = max(int((g.to(torch.int64) - r.to(torch.int64)).abs().max())
              if g.numel() else 0 for g, r in zip(got, want))
    if err != 0 or any(g.shape != r.shape or g.dtype != torch.int32
                       for g, r in zip(got, want)):
        raise AssertionError(f"gate_level_trace/{label}: kernel disagrees "
                             f"with its plain version (max |err| {err})")
    row = dict(variant="gate_level_trace", shape=label, **extra,
               times=list(times.shape), weights=list(weights.shape), n=n,
               k=k, t_steps=t_steps, units=len(units),
               clipped=int(got[1].sum()), max_abs_err=err)
    if timed:
        call_ms = time_ms(fn)
        ms, per_call = kernel_ms(fn, key="gate_level_kernel")
        bound, bound_by = gate_trace_bound_ms(times, weights, t_steps,
                                              len(units))
        row.update(ms=call_ms if ms is None else ms,
                   ms_source="cuda_events" if ms is None else "profiler",
                   kernels_per_call=per_call, call_ms=call_ms,
                   plain_ms=time_ms(plain, reps=5, warmup=1),
                   bound_ms=bound, bound_by=bound_by, library_ms=None)
    emit("kernels", **row)
    return row


def synthetic_gate_trace_cases(dev):
    """(label, times, weights, units, n, k, t_steps) for the gate-level
    kernel, checked only: the rows form of ``simulate_neuron`` (B = Q = 1)
    over 70 ticks, a cycle one tick past a word, n = 20 with a pruned
    odd-even transposition network, the widest row with its full sorter,
    k = 8 (the wide counters), B = 0."""
    rng = np.random.default_rng(4)

    def draw(shape_t, shape_w, t_steps):
        t = np.where(rng.random(shape_t) < 0.6,
                     rng.integers(0, t_steps + 4, shape_t), coding.NO_SPIKE)
        return (torch.from_numpy(t.astype(np.int32)).to(dev),
                torch.randint(0, 9, shape_w, dtype=torch.int32,
                              generator=torch.Generator().manual_seed(
                                  len(shape_t))).to(dev))

    transposition = [(i, i + 1) for r in range(20)
                     for i in range(r % 2, 19, 2)]
    l1 = topk_prune.topk_network("optimal", 16, 3).units
    return [
        ("rows_form_t70", *draw((4096, 1, 16), (4096, 1, 16), 70), l1, 16,
         3, 70),
        ("t33", *draw((8, 40, 16), (8, 12, 16), 33), l1, 16, 3, 33),
        ("n20_t40", *draw((64, 20), (12, 20), 40),
         topk_prune.prune_topk(transposition, 20, 3).units, 20, 3, 40),
        ("n256_bitonic_sorter", *draw((2, 16, 256), (2, 8, 256), 32),
         sorting_networks.get_network("bitonic", 256), 256, 3, 32),
        ("k8_sorter", *draw((64, 16), (12, 16), 32),
         sorting_networks.get_network("bitonic", 16), 16, 8, 32),
        ("b0", *draw((4, 0, 16), (4, 12, 16), 32), l1, 16, 3, 32),
    ]


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


def ssd_bound_ms(u, log_decay, b, y, chunk, heads):
    """Least time the card could take for one SSD scan call: the larger of
    the bytes it must move (u, log_decay, the shared b and c read once, y
    written once) over the memory rate, and the operations these inputs
    need over the tensor cores' peak for their type (bf16 inputs at the
    bf16 rate; float32 inputs at the float32-accurate 3xTF32 rate): per
    batch row and chunk C B^T for s <= t (shared by the heads); per row and
    chunk the causal ((C B^T) o D) U, C S_in (not for the first chunk:
    S_in = 0) and the state update (not after the last chunk), 2 per
    multiply-add. Returns ``(ms, "bytes" | "operations")``."""
    rows, L, p = u.shape
    n = b.shape[-1]
    lens = [min(chunk, L - t0) for t0 in range(0, L, chunk)]
    tri = sum(lc * (lc + 1) // 2 for lc in lens)
    macs = (rows // heads) * tri * n + rows * tri * p \
        + rows * (L - lens[0]) * n * p + rows * (L - lens[-1]) * n * p
    nbytes = sum(t.numel() * t.element_size() for t in (u, log_decay, y)) \
        + 2 * b.numel() * b.element_size()
    peak = BF16_FLOPS_PER_S if u.dtype == torch.bfloat16 \
        else F32_SPLIT_FLOPS_PER_S
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, 2 * macs / peak
    return 1e3 * max(by_bytes, by_ops), \
        ("bytes" if by_bytes > by_ops else "operations")


def check_ssd(label, u, log_decay, b, c, chunk, heads, *, timed=True,
              **extra) -> Dict[str, Any]:
    """One SSD scan call against its plain version computed in float64
    from the same inputs on the card, or raise. Tolerance, elementwise,
    with s = max |reference|: float32 output |y - ref| <= 5e-4 s; bfloat16
    output |y - ref| <= 2^-8 |ref| + 1e-4 s (one bf16 rounding of an f32
    result). The split model (``ssd_scan_split_model``, the kernel's bf16
    splits on the host, not its sum orders) is reported beside it, not
    held: its own error against the reference and its gap to the kernel.
    When ``timed``: its device time, call time, the plain version's time
    (float32, as the CPU path runs it) and its bound."""
    def fn():
        return ss._ssd_scan(u, log_decay, b, c, chunk, heads)

    def plain():
        return ss._ssd_scan_plain(u, log_decay, b, c, chunk, heads)

    got = fn()
    want = ss._ssd_scan_plain(u.double(), log_decay.double(), b.double(),
                              c.double(), chunk, heads)
    model = ss.ssd_scan_split_model(u, log_decay, b, c, chunk, heads)
    torch.cuda.synchronize()
    err = (got.double() - want).abs()
    scale = float(want.abs().max())
    if u.dtype == torch.float32:
        ok = err <= 5e-4 * scale
    else:
        ok = err <= 2.0 ** -8 * want.abs() + 1e-4 * scale
    max_err = float(err.max())
    if got.shape != u.shape or got.dtype != u.dtype or not bool(ok.all()):
        raise AssertionError(f"ssd_scan/{label}: kernel disagrees with its "
                             f"plain version (max |err| {max_err}, scale "
                             f"{scale})")
    row = dict(variant="ssd_scan", shape=label, **extra, u=list(u.shape),
               dtype=str(u.dtype).split(".")[-1], n=int(b.shape[-1]),
               chunk=chunk, heads=heads, max_abs_err=max_err,
               max_err_over_scale=max_err / scale,
               model_err_over_scale=float((model.double() - want).abs()
                                          .max()) / scale,
               model_gap_over_scale=float((got.double() - model.double())
                                          .abs().max()) / scale)
    if timed:
        call_ms = time_ms(fn)
        ms, per_call = kernel_ms(fn, reps=20, key="ssd_scan")
        bound, bound_by = ssd_bound_ms(u, log_decay, b, got, chunk, heads)
        row.update(ms=call_ms if ms is None else ms,
                   ms_source="cuda_events" if ms is None else "profiler",
                   kernels_per_call=per_call,
                   call_ms=call_ms, plain_ms=time_ms(plain, reps=5, warmup=1),
                   bound_ms=bound, bound_by=bound_by, library_ms=None)
    emit("kernels", **row)
    return row


def synthetic_ssd_cases(dev, operands, chunk, heads):
    """(label, u, log_decay, b, c, chunk, heads, timed) for the SSD scan:
    one prefill call's ``operands`` in float32 (timed); the smoke shape (chunk
    32, P = N = 16); ragged L = 1, 127, 129, 2047 at the model's shapes;
    log_decay -30 (the state resets every step); the long carry with an
    impulse (tests/test_kernels.py)."""
    rng = np.random.default_rng(7)

    def make(rows, heads, L, p, n, dtype=torch.bfloat16):
        u = torch.from_numpy(rng.standard_normal((rows, L, p),
                                                 dtype=np.float32))
        ld = -torch.from_numpy(np.logaddexp(
            rng.standard_normal((rows, L)), 0.0).astype(np.float32))
        b, c = (torch.from_numpy(0.3 * rng.standard_normal(
            (rows // heads, L, n), dtype=np.float32)) for _ in range(2))
        return [u.to(dev, dtype), ld.to(dev), b.to(dev, dtype),
                c.to(dev, dtype)]

    u, ld, b, c = operands
    cases = [("prefill_call_float32", u.float(), ld, b.float(), c.float(),
              chunk, heads, True),
             ("smoke_chunk32_p16_n16", *make(16, 8, 70, 16, 16), 32, 8,
              False)]
    for L in (1, 127, 129, 2047):
        cases.append((f"ragged_L{L}", *make(48, 48, L, 64, 128), 128, 48,
                      False))
    reset = make(4, 2, 300, 64, 128, torch.float32)
    reset[1] = torch.full_like(reset[1], -30.0)
    cases.append(("log_decay_-30", *reset, 128, 2, False))
    impulse = torch.zeros((1, 200, 2), device=dev)
    impulse[0, 0] = 1.0
    ones = torch.ones((1, 200, 2), device=dev)
    cases.append(("long_carry_impulse", impulse,
                  torch.full((1, 200), float(np.log(0.9)), device=dev),
                  ones, ones.clone(), 64, 1, False))
    return cases


def gate_bound_ms(t, e, k):
    """Least time the card could take for one gate call: the logits read
    once (T*E*4 bytes) and the probabilities and ids written once (T*k*8)
    over the memory rate; its operations (E exps and ~k*E compares a row)
    bind far less. Returns ``(ms, "bytes")``."""
    return 1e3 * (t * e * 4 + t * k * 8) / HBM_BYTES_PER_S, "bytes"


def check_gate(label, logits, k, renorm, *, timed=True,
               **extra) -> Dict[str, Any]:
    """One gate call against its plain version on the same inputs on the
    card: ids bit-exact and probabilities within 1e-6 (the reference's own
    tolerance, tests/test_kernels.py), or raise. When ``timed``: device ms
    (profiler), call ms (CUDA events), the plain version's ms, the byte
    bound and the library call's ms — ``torch.softmax`` + ``torch.topk`` +
    renormalise, the same function but for the order among equal logits,
    which ``torch.topk`` leaves unspecified."""
    def fn():
        return mg._moe_gate(logits, k, renorm)

    def plain():
        return mg.moe_gate_topk_plain(logits, k, renorm)

    def library():
        probs, ids = torch.topk(torch.softmax(logits, dim=-1), k, dim=-1)
        if renorm:
            probs = probs / probs.sum(dim=-1, keepdim=True)
        return probs, ids

    (p, i), (wp, wi) = fn(), plain()
    torch.cuda.synchronize()
    err = float((p - wp).abs().max()) if p.numel() else 0.0
    if not torch.equal(i, wi) or err > 1e-6 or p.dtype != torch.float32:
        raise AssertionError(f"moe_gate/{label}: kernel disagrees with its "
                             f"plain version (ids equal "
                             f"{torch.equal(i, wi)}, max |err| {err})")
    t, e = logits.shape
    row = dict(variant="moe_gate_topk", shape=label, **extra, logits=[t, e],
               k=k, renorm=renorm, ids_bit_exact=True, max_abs_err=err)
    if timed:
        call_ms = time_ms(fn)
        ms, per_call = kernel_ms(fn, key="moe_gate")
        bound, bound_by = gate_bound_ms(t, e, k)
        row.update(ms=call_ms if ms is None else ms,
                   ms_source="cuda_events" if ms is None else "profiler",
                   kernels_per_call=per_call,
                   call_ms=call_ms, plain_ms=time_ms(plain, reps=10),
                   bound_ms=bound, bound_by=bound_by,
                   library_ms=time_ms(library),
                   library_call="softmax + topk + renormalise (tie order "
                                "unspecified)")
    emit("kernels", **row)
    return row


def edge_rows(e, rng):
    """Three rows of E logits: all equal; a top pair of -0.0 (id 1) and
    +0.0 (id 4), which compare equal, so id 1 goes first; all below -1e30
    but ids E - 1 and E // 2, so from the third round on the kernel picks
    a masked expert (-1e30) again, as the reference's kernel does."""
    equal = np.full(e, 0.25, np.float32)
    zeros = -1.0 - rng.random(e).astype(np.float32)
    zeros[1], zeros[4] = -0.0, 0.0
    low = (-2e30 * (1.0 + rng.random(e))).astype(np.float32)
    low[e - 1], low[e // 2] = 1.0, 0.5
    return np.stack([equal, zeros, low])


def synthetic_gate_cases(dev):
    """(label, logits, k, renorm) for the gate kernel: the reference's test
    shapes (tests/test_kernels.py) with renorm both ways, the edge rows
    (:func:`edge_rows`) at E = 8, 33, 64, 160, 256 with k = 6 and k = E,
    one row, a row count that is not a multiple of the kernel's 8 rows per
    block, tie-heavy logits (integers in [-2, 2]), logits of magnitude 80,
    and the widest row the kernel holds."""
    rng = np.random.default_rng(8)

    def normal(t, e, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal((t, e))).astype(
            np.float32)).to(dev)

    cases = [(f"ref_{t}x{e}_k{k}_renorm{int(r)}", normal(t, e), k, r)
             for t, e, k in ((7, 8, 2), (300, 64, 6), (1000, 128, 2))
             for r in (True, False)]
    ties = torch.from_numpy(rng.integers(-2, 3, (8195, 64)).astype(
        np.float32)).to(dev)
    for e in (8, 33, 64, 160, 256):
        edge = torch.from_numpy(edge_rows(e, rng)).to(dev)
        for k in sorted({min(6, e), e}):
            cases.append((f"edge_rows_E{e}_k{k}", edge, k, True))
    return cases + [
        ("rows_1", normal(1, 64), 6, True),
        ("rows_8195", normal(8195, 64), 6, True),
        ("ties_8195x64", ties, 6, True),
        ("ties_8195x64_norenorm", ties, 6, False),
        ("magnitude_80", normal(4096, 64, 80.0), 6, True),
        (f"experts_{mg.MAX_EXPERTS}", normal(33, mg.MAX_EXPERTS), 8, True),
    ]


def check_gate_cap(dev) -> None:
    """E above the kernel's cap must raise ``ValueError`` on the card."""
    wide = torch.zeros((4, mg.MAX_EXPERTS + 1), device=dev)
    try:
        mg.moe_gate_topk(wide, 2)
    except ValueError as exc:
        emit("kernels", variant="moe_gate_topk", shape="experts_above_cap",
             logits=list(wide.shape), raised=str(exc))
        return
    raise AssertionError("moe_gate: E above the cap did not raise")


def phase_kernels(dev, captured, floor_ms) -> Dict[str, Dict[str, Any]]:
    """Every launch variant against its plain version on the card: each
    distinct call the main path made (its own operands), the clip variants
    on the main path's layer and bank operands, then the synthetic cases.
    The gate's timed rows carry the launch floor ``floor_ms``. Returns,
    per wrapper, the row of the call its first path made most (for unary
    top-k, the gate level, the SSD scan and the gate, the first path's
    first call)."""
    main_rows: Dict[str, Dict[str, Any]] = {}
    ssd_call = None
    timed_calls = set()     # an RNL call of an earlier path's shape and
    for path, cases in captured.items():     # options is checked, not timed
        for i, case in enumerate(cases):
            if case["wrapper"] == "ssd_scan":
                for k, ops in enumerate(case["operands"]):
                    row = check_ssd(f"{path}#{i}/call{k}", *ops,
                                    case["chunk"], case["heads"],
                                    timed=k == 0, path=path,
                                    calls=case["calls"])
                    main_rows.setdefault("ssd_scan", row)
                ssd_call = (case["operands"][0], case["chunk"], case["heads"])
                continue
            if case["wrapper"] == "moe_gate_topk":
                row = check_gate(f"{path}#{i}", case["logits"], case["k"],
                                 case["renorm"], path=path,
                                 calls=case["calls"], floor_ms=floor_ms)
                main_rows.setdefault("moe_gate_topk", row)
                continue
            if case["wrapper"] == "gate_level_trace":
                row = check_gate_trace(
                    f"{path}#{i}", case["times"], case["weights"],
                    case["units"], case["n"], case["k"], case["t_steps"],
                    path=path, calls=case["calls"])
                main_rows.setdefault("gate_level_trace", row)
                continue
            if case["wrapper"].startswith("unary_topk"):
                row = check_topk(f"{path}#{i}", case["bits"], case["units"],
                                 case["n"], case["k"],
                                 count=case["wrapper"] == "unary_topk_count",
                                 path=path, calls=case["calls"])
                main_rows.setdefault(case["wrapper"], row)
                continue
            variant = VARIANT[case["wrapper"]]
            x, w, kw = case["times"], case["weights"], case["kw"]
            call = (variant, tuple(x.shape), tuple(w.shape),
                    tuple(sorted(kw.items())))
            timed = call not in timed_calls
            timed_calls.add(call)
            row = check_and_time(variant, f"{path}#{i}", x, w, kw, timed,
                                 path=path, calls=case["calls"])
            best = main_rows.get(case["wrapper"])
            if timed and (best is None or (best["path"] == path
                                           and row["calls"]
                                           > best["calls"])):
                main_rows[case["wrapper"]] = row
            if variant in ("layer", "bank"):
                check_and_time(variant + "+clip", f"{path}#{i}", x, w,
                               {**kw, "with_clip": True}, timed, path=path)
    for variant, label, x, w, kw in synthetic_cases(dev):
        check_and_time(variant, label, x, w, kw)
    for label, bits, net, timed in synthetic_topk_cases(dev):
        for count in (True, False):
            check_topk(label, bits, net.units, net.n, net.k, count=count,
                       timed=timed)
    for label, *case in synthetic_gate_trace_cases(dev):
        check_gate_trace(label, *case, timed=False)
    if ssd_call is not None:
        for label, *ops, chunk, heads, timed in synthetic_ssd_cases(
                dev, *ssd_call):
            check_ssd(label, *ops, chunk, heads, timed=timed)
    for label, logits, k, renorm in synthetic_gate_cases(dev):
        check_gate(label, logits, k, renorm, timed=False)
    check_gate_cap(dev)
    return main_rows


def check_launches(path, counts, cases, st) -> None:
    """Raise unless ``path``'s run launched the fused attention kernel as
    often as ``path.attention`` says, its kernel (as often as
    ``path.launches`` says, where it says), no other, and made exactly the
    calls the capture ``cases`` saw."""
    attention = path.attention(st) if callable(path.attention) \
        else path.attention
    if counts[ATTENTION_KERNEL] != attention:
        raise AssertionError(f"{path.name}: {counts[ATTENTION_KERNEL]} "
                             f"launches of {ATTENTION_KERNEL}, expected "
                             f"{attention}")
    counts = {k: v for k, v in counts.items() if k != ATTENTION_KERNEL}
    seen = {name: 0 for name in REPLACES}
    for case in cases:
        seen[case["wrapper"]] += case["calls"]
    if path.kernel is not None and counts[path.kernel] <= 0:
        raise AssertionError(f"{path.name}: {path.kernel} was not launched")
    want = path.launches(st) if callable(path.launches) else path.launches
    if want is not None and counts[path.kernel] != want:
        raise AssertionError(f"{path.name}: {counts[path.kernel]} launches "
                             f"of {path.kernel}, expected {want}")
    if counts != seen or any(n for name, n in counts.items()
                             if name != path.kernel):
        raise AssertionError(f"{path.name}: launches {counts}, calls "
                             f"{seen}, expected only {path.kernel}")


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
        check_launches(path, counts, captured[path.name], st)
    return launches


#: round-robin rounds of the learning-cost phase
LEARN_ROUNDS = 5
#: the interpreter's thread switch interval, seconds, while ``snap50_switch``
#: serves (the default is 0.005)
SNAPSHOT_SWITCH_S = 0.0002


def phase_learn_ratio(dev, streams, ff, p_ff, root) -> None:
    """Learning's cost end to end, as benchmarks/bench_serve_learn.py
    measures it (that benchmark gates the every1/off ratio at 2x and
    snapshots every 50 steps at < 10 % over learning alone, on a CPU;
    here both are reported, not held): the learning workload drained by
    engines with learning off, every step, every 4th step, and every step
    with async snapshots every ``LEARN_SNAPSHOT_EVERY`` steps (``snap50``,
    to a directory under ``root``), warm, in ``LEARN_ROUNDS`` round-robin
    rounds so that the host's drift lands on every variant. Per variant
    the median volleys/s and latency p50 (host clock; each step ends in a
    device-to-host copy); per learning variant the median of its
    per-round time ratios to learning off. ``snap50_sync`` writes the same
    snapshots on the serve thread; ``snap50_switch`` is ``snap50`` served
    with the interpreter's thread switch interval cut to
    ``SNAPSHOT_SWITCH_S``, which bounds how long the serve thread can wait
    for the interpreter lock while the writer thread holds it. Per
    snapshot variant: ``overhead``, the
    median per-round ratio to ``every1`` minus 1 (``snapshot_overhead``
    for ``snap50``), each round's, and ``save_ms_mean``, the serve
    thread's mean host time in one ``CheckpointManager.maybe_save`` that
    saved (``snapshot_ms_mean`` for ``snap50``: the host copy and the
    writer thread's start). Each round starts at another variant."""
    pop = learn_population(streams, LEARN_CLIENTS, LEARN_CYCLES)
    snap = dict(learn=True, stdp_every=1,
                checkpoint_every=LEARN_SNAPSHOT_EVERY)
    variants = {"off": {}, "every1": dict(learn=True, stdp_every=1),
                "every4": dict(learn=True, stdp_every=4),
                "snap50": dict(snap, checkpoint_async=True),
                "snap50_sync": dict(snap, checkpoint_async=False),
                "snap50_switch": dict(snap, checkpoint_async=True)}
    engines = {}
    save_ms: Dict[str, List[float]] = {}
    for name, kw in variants.items():
        if "checkpoint_every" in kw:
            kw["checkpoint_dir"] = tempfile.mkdtemp(dir=root)
        eng = tnn_engine.TNNEngine(p_ff, ff, tnn_engine.TNNServeConfig(
            n_slots=LEARN_SLOTS, **kw), device=dev)
        eng.serve(pop)                       # warm the path
        eng.checkpoint_wait()
        engines[name] = eng
        if eng._ckpt is not None:
            save_ms[name] = []

            def timed_save(step, state, save=eng._ckpt.maybe_save,
                           times=save_ms[name]):
                t0 = time.perf_counter()
                saved = save(step, state)
                if saved:
                    times.append(1e3 * (time.perf_counter() - t0))
                return saved

            eng._ckpt.maybe_save = timed_save
    runs: Dict[str, List[Dict[str, float]]] = {name: [] for name in variants}
    order = list(engines)
    switch = sys.getswitchinterval()
    for r in range(LEARN_ROUNDS):
        # each round starts at another variant: no variant keeps a place
        for name in order[r % len(order):] + order[:r % len(order)]:
            eng = engines[name]
            eng.reset_stats()
            if name == "snap50_switch":
                sys.setswitchinterval(SNAPSHOT_SWITCH_S)
            try:
                eng.serve(pop)
                eng.checkpoint_wait()
            finally:
                sys.setswitchinterval(switch)
            runs[name].append(eng.stats())
    fields = {}
    for name, sts in runs.items():
        fields[name] = dict(
            volleys_per_s=statistics.median(s["volleys_per_s"] for s in sts),
            latency_ms_p50=statistics.median(s["latency_ms_p50"]
                                             for s in sts))
        if name != "off":
            fields[name]["time_over_off"] = statistics.median(
                s["run_s"] / o["run_s"] for s, o in zip(sts, runs["off"]))
        if name not in save_ms:
            continue
        eng = engines[name]
        on_disk = ckpt.latest_step(variants[name]["checkpoint_dir"])
        if on_disk != eng.step_id // LEARN_SNAPSHOT_EVERY \
                * LEARN_SNAPSHOT_EVERY or not save_ms[name]:
            raise AssertionError(f"learn_cost {name}: snapshot {on_disk} on "
                                 f"disk after step {eng.step_id}, "
                                 f"{len(save_ms[name])} saves timed")
        ratios = [s["run_s"] / e["run_s"] - 1.0
                  for s, e in zip(sts, runs["every1"])]
        fields[name].update(
            overhead=statistics.median(ratios), overhead_rounds=ratios,
            snapshots=eng.n_snapshots,
            save_ms_mean=statistics.mean(save_ms[name]),
            save_ms_max=max(save_ms[name]))
    emit("serve", run="learn_cost", rounds=LEARN_ROUNDS, n_slots=LEARN_SLOTS,
         volleys=sum(s.shape[0] for s in pop), **fields,
         snapshot_overhead=fields["snap50"]["overhead"],
         snapshot_ms_mean=fields["snap50"]["save_ms_mean"],
         snapshot_gate=0.10)


def device_events(prof):
    """The profile's CUDA activity (kernels and copies), one entry a name."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def device_share(dev_events, wall_ms):
    """Device busy time (the sum of the CUDA activity ``dev_events``), the
    idle share 1 - busy / wall, and the top device ops."""
    busy_ms = sum(e.self_device_time_total for e in dev_events) / 1e3
    top = sorted(dev_events, key=lambda e: -e.self_device_time_total)[:12]
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                idle_share=1.0 - busy_ms / wall_ms,
                device_ops=sum(e.count for e in dev_events),
                top=[dict(name=e.key[:80], count=e.count,
                          ms=e.self_device_time_total / 1e3) for e in top])


#: host-clock milliseconds a path profile spans at least: a shorter path
#: runs back to back inside one profile
PROFILE_MIN_MS = 20.0
#: marker kernels (``spin_kernel``, from ``torch.cuda._sleep``) launched
#: inside a path profile before and after its runs: late in the script a
#: profile can drop a dozen to 32 device records at one end (once all 32
#: of the audio prefill's leading markers), which the markers take
#: instead of the path's own
PROFILE_MARKERS = 64


def kernel_count(event) -> int:
    """Kernels launched under a profiled CPU op, its children's included."""
    return len(event.kernels) + sum(map(kernel_count, event.cpu_children))


def phase_profile_path(path, span: Optional[str] = None):
    """Where one main-path run's time goes: ``path.run()`` (already warm)
    under the profiler, repeated back to back until the runs span
    ``PROFILE_MIN_MS``, between ``PROFILE_MARKERS`` marker kernels on each
    side; every number is per run, the markers left out. ``markers_lost``
    counts the markers missing before and after the runs (by their start
    times). The profile is ``recorded`` only when markers survived on both
    sides and every op of the path has a whole multiple of the runs;
    otherwise the line carries no busy time or idle share. The profiler's
    host cost makes the idle share an upper estimate. ``span`` names a
    ``record_function`` range inside the run: the line then also carries
    the device time of the kernels launched under it and their top ops."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path.run()
    torch.cuda.synchronize()
    runs = max(1, math.ceil(PROFILE_MIN_MS /
                            (1e3 * (time.perf_counter() - t0))))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_MARKERS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(runs):
            path.run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / runs
        for _ in range(PROFILE_MARKERS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
    starts = [(e.time_range.start, "spin_kernel" in e.name)
              for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.name != span]
    own = [t for t, marker in starts if not marker]
    seen = [sum(1 for t, marker in starts if marker and t < min(own)),
            sum(1 for t, marker in starts if marker and t > max(own))] \
        if own else [0, 0]
    lost = [PROFILE_MARKERS - n for n in seen]
    ops = [e for e in device_events(prof)
           if "spin_kernel" not in e.key and e.key != span]
    if not ops or not all(seen) or any(e.count % runs for e in ops):
        emit("profile", run=path.name, runs=runs, recorded=False,
             markers_lost=lost, wall_ms=wall_ms, device_busy_ms=None,
             idle_share=None, device_ops_recorded=len(own), top=[])
        return
    share = device_share(ops, wall_ms * runs)
    spans = {}
    if span is not None:
        # the range's device time, by the op in it that launched each kernel
        by_op: Dict[str, List[float]] = {}
        for e in prof.events():
            if e.name == span and e.device_type != \
                    torch.autograd.DeviceType.CUDA:
                for op in e.cpu_children:
                    if kernel_count(op):
                        acc = by_op.setdefault(op.name, [0, 0.0])
                        acc[0] += kernel_count(op)
                        acc[1] += op.device_time_total / 1e3
        top = sorted(by_op.items(), key=lambda kv: -kv[1][1])
        spans[span] = dict(
            device_ms=sum(v[1] for v in by_op.values()) / runs,
            device_ops=sum(v[0] for v in by_op.values()) / runs,
            top=[dict(op=name, count=n / runs, ms=ms / runs)
                 for name, (n, ms) in top])
    emit("profile", run=path.name, runs=runs, recorded=True,
         markers_lost=lost, wall_ms=wall_ms,
         device_busy_ms=share["device_busy_ms"] / runs,
         idle_share=share["idle_share"],
         device_ops=share["device_ops"] // runs,
         top=[dict(op, count=op["count"] // runs, ms=op["ms"] / runs)
              for op in share["top"]], spans=spans)


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
    emit("profile", run="auto", steps=steps,
         **device_share(device_events(prof), wall_ms))


#: the profiler range around each STDP update in a learning step's profile
STDP_SPAN = "stdp_update_column_minibatch"


def phase_profile_learn(dev, streams, ff, p_ff):
    """Where a learning step's time goes: one ``TNNEngine`` step with STDP
    every step, at 4 slots (bench_serve_learn's workload) and at 64 (the
    serve path's), each run back to back under the profiler as
    :func:`phase_profile_path` does, with every STDP update inside a
    ``record_function`` range so that its kernels are named apart."""
    real = stdp.stdp_update_column_minibatch

    def spanned(*args, **kw):
        with torch.profiler.record_function(STDP_SPAN):
            return real(*args, **kw)

    for n_slots in (LEARN_SLOTS, N_SLOTS):
        # enough full steps for any profile: 64 at either size
        pop = learn_population(streams, 8 * n_slots, LEARN_CYCLES)
        eng = tnn_engine.TNNEngine(
            p_ff, ff, tnn_engine.TNNServeConfig(n_slots=n_slots, learn=True),
            device=dev)
        eng.serve(pop[:n_slots])             # warm the path
        for s in pop:
            eng.submit(s)
        path = Path(f"learn_step_{n_slots}", "rnl_fire_times_layer",
                    eng.step, lambda *_: {})
        stdp.stdp_update_column_minibatch = spanned
        try:
            phase_profile_path(path, span=STDP_SPAN)
        finally:
            stdp.stdp_update_column_minibatch = real


# ------------------------------------------------------------------ mesh

#: the TPU functions the sharded wrappers replace; neither has a kernel body
#: of its own: each launches row 1's or row 3's kernel on a rank's tile
MESH_REPLACES = {
    "rnl_fire_times_layer_sharded": "src/repro/kernels/rnl_shard.py:63",
    "rnl_fire_times_compact_sharded": "src/repro/kernels/rnl_shard.py:92"}
#: the kernel each sharded wrapper launches
MESH_INNER = {"rnl_fire_times_layer_sharded": "rnl_fire_times_layer",
              "rnl_fire_times_compact_sharded": "rnl_fire_times_compact"}
MESH_WRAPPER_SOURCE = "src/repro_torch/kernels/rnl_shard.py"
#: the tiles: every rank's block of an m-way column by d-way data mesh,
#: launched one after another on the one card (all divide 32, 24 and 64)
MESH_COLUMNS, MESH_DATA = (2, 4, 8), (1, 2)
#: rounds of the per-step wall comparison, each single-device, mesh, mesh,
#: single-device
MESH_WALL_ROUNDS = 3
#: (data, column) sizes whose column axis the served layers' column counts
#: (32, 24) do not divide: every rank holds the whole stack and, on the
#: card, launches the unsharded kernel on its (C, B_local, n) block
MESH_REPLICATED = ((2, 3), (2, 16))


@dataclasses.dataclass
class MeshShape:
    """What the sharding rules and the sharded wrappers read of a mesh: its
    dim names and sizes. Stands in for a DeviceMesh of a shape that one
    card cannot hold, so that each rank's tile is launched through the
    wrappers, which talk to no other rank."""

    dims: Dict[str, int]

    @property
    def mesh_dim_names(self):
        return tuple(self.dims)

    @property
    def shape(self):
        return tuple(self.dims.values())


def mesh_counts() -> Dict[str, int]:
    return {**launch_counts(), **rs.LAUNCHES}


def mesh_runs(dev, mesh, streams, ff, p_ff, served, single, root
              ) -> Dict[str, Dict[str, int]]:
    """The main path through ``TNNEngine(mesh=)``: the serve population on
    ``auto`` (→ ``fused``), ``fused_compact`` and L1 recurrent with 4
    micro-batches, the learning workload with STDP every step, and
    ``serve_resilient`` through one injected failure. Each run's outputs
    (and learned weights) must equal its single-device path's bit for bit,
    every step must run the engine that path ran, and the sharded wrapper
    must launch as often as the single-device path launched its kernel,
    once per layer per step, each launch its inner kernel's, and no other
    kernel. The launch counts are set to 0 just before each run and read
    just after; returns them by run."""
    rec = serve_network(recurrent=True)
    p_rec = network.init_network(torch.Generator().manual_seed(1), rec,
                                 device=dev)
    pop = learn_population(streams, LEARN_CLIENTS, LEARN_CYCLES)

    def engine(params, net, **kw):
        return tnn_engine.TNNEngine(params, net,
                                    tnn_engine.TNNServeConfig(**kw),
                                    mesh=mesh)

    def serve(base, backend, net, params, micro):
        def run():
            eng = engine(params, net, n_slots=N_SLOTS, backend=backend,
                         pipeline_microbatches=micro)
            results = eng.serve(streams)
            if not same_outputs(results, served[base]):
                raise AssertionError(f"mesh {base}: outputs differ from "
                                     f"the single-device engine's")
            return eng.stats(), dict(requests=len(streams), bit_exact=True)
        return run

    def learn():
        eng = engine(p_ff, ff, n_slots=LEARN_SLOTS, learn=True,
                     stdp_every=1)
        results = eng.serve(pop)
        want_out, want_p = served["learn_every1"]
        if not same_outputs(results, want_out) \
                or not same_weights(eng.whole_params(), want_p):
            raise AssertionError("mesh learn_every1: outputs or weights "
                                 "differ from the single-device engine's")
        return eng.stats(), dict(requests=len(pop),
                                 stdp_updates=eng.n_stdp_updates,
                                 weights_equal=True, bit_exact=True)

    def resilient():
        directory = tempfile.mkdtemp(dir=root)
        eng = engine(p_ff, ff, n_slots=N_SLOTS, checkpoint_dir=directory,
                     checkpoint_every=SERVE_SNAPSHOT_EVERY,
                     checkpoint_async=False)
        results, report = tnn_engine.serve_resilient(
            eng, streams, failure_injector=one_shot_failure(SERVE_FAIL_AT))
        restored = SERVE_FAIL_AT // SERVE_SNAPSHOT_EVERY \
            * SERVE_SNAPSHOT_EVERY
        if report["restarts"] != 1 or report["restored_steps"] != [restored]:
            raise AssertionError(f"mesh resilient_serve: report {report}")
        if not same_outputs(results, served["auto"]):
            raise AssertionError("mesh resilient_serve: outputs differ "
                                 "from the uninterrupted run")
        return eng.stats(), dict(requests=len(streams),
                                 restored_step=restored,
                                 resubmitted=len(report["resubmitted"][0]),
                                 bit_exact=True)

    runs = [("mesh_auto", "auto", "fused", "rnl_fire_times_layer_sharded",
             serve("auto", "auto", ff, p_ff, 1)),
            ("mesh_fused_compact", "fused_compact", "fused_compact",
             "rnl_fire_times_compact_sharded",
             serve("fused_compact", "fused_compact", ff, p_ff, 1)),
            ("mesh_auto_recurrent_pipelined", "auto_recurrent_pipelined",
             "fused", "rnl_fire_times_layer_sharded",
             serve("auto_recurrent_pipelined", "auto", rec, p_rec, 4)),
            ("mesh_learn_every1", "learn_every1", "fused",
             "rnl_fire_times_layer_sharded", learn),
            ("mesh_resilient_serve", "resilient_serve", "fused",
             "rnl_fire_times_layer_sharded", resilient)]
    launches: Dict[str, Dict[str, int]] = {}
    for name, base, want_engine, wrapper, run in runs:
        torch.cuda.synchronize()
        reset_launches()
        rs.reset_launches()
        t0 = time.perf_counter()
        st, fields = run()
        torch.cuda.synchronize()
        run_ms = 1e3 * (time.perf_counter() - t0)
        counts = mesh_counts()
        launches[name] = counts
        engines = engine_steps(st)
        if engines != {want_engine: int(st["n_steps"])}:
            raise AssertionError(f"{name}: engines {engines}, expected every "
                                 f"step on {want_engine}")
        inner = MESH_INNER[wrapper]
        want = single[base][inner]
        others = {k: v for k, v in counts.items()
                  if v and k not in (wrapper, inner)}
        if counts[wrapper] <= 0 or counts[wrapper] != want \
                or counts[inner] != want or others:
            raise AssertionError(f"{name}: launches {counts}, expected "
                                 f"{want} of {wrapper} and of {inner} (the "
                                 f"single-device {base} path's) and no "
                                 f"other")
        emit("mesh", run=name, **fields, steps=int(st["n_steps"]),
             engine_steps=engines, run_ms=run_ms, launches=counts,
             single_device_launches=single[base])
    return launches


def mesh_wall(dev, mesh, streams, ff, p_ff) -> None:
    """The serve population on ``auto`` through the single-device engine
    and the mesh engine in turns: the engines' own per-step wall (host
    clock, each step ending in its device-to-host copy), so the mesh's
    overhead at world size 1 (the wrappers' checks and the blocks'
    bookkeeping: over axes of one rank no collective runs)."""
    per_step: Dict[str, List[float]] = {"single": [], "mesh": []}
    for _ in range(MESH_WALL_ROUNDS):
        for kind in ("single", "mesh", "mesh", "single"):
            eng = tnn_engine.TNNEngine(
                p_ff, ff, tnn_engine.TNNServeConfig(n_slots=N_SLOTS),
                device=dev if kind == "single" else None,
                mesh=mesh if kind == "mesh" else None)
            eng.serve(streams)
            st = eng.stats()
            per_step[kind].append(1e3 * st["run_s"] / st["n_steps"])
    single_ms = statistics.median(per_step["single"])
    mesh_ms = statistics.median(per_step["mesh"])
    emit("mesh", run="wall_per_step", single_ms=single_ms, mesh_ms=mesh_ms,
         mesh_over_single=mesh_ms / single_ms,
         single_ms_all=per_step["single"], mesh_ms_all=per_step["mesh"])


def launch_device_ms(fn, reps: int = 50):
    """Device time of one RNL launch, for an ``fn`` that launches one a
    call: the profiler's total over the RNL kernels it recorded in
    ``reps`` calls, per recorded kernel, and how many it recorded (a late
    profile can lose its leading device records); ``(None, 0)`` when it
    recorded none."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "rnl_" in e.key]
    count = sum(e.count for e in hits)
    if not count:
        return None, 0
    return sum(e.self_device_time_total for e in hits) / 1e3 / count, count


def mesh_profiles(dev, mesh, streams, ff, p_ff) -> None:
    """Where a serving step's time goes, single-device against the mesh
    engine at world size 1 (64 slots): one step at a time under the
    profiler (:func:`phase_profile_path`)."""
    for name, kw in (("serve_step_64", dict(device=dev)),
                     ("mesh_step_64", dict(mesh=mesh))):
        eng = tnn_engine.TNNEngine(
            p_ff, ff, tnn_engine.TNNServeConfig(n_slots=N_SLOTS), **kw)
        eng.serve(streams[:N_SLOTS])
        for s in streams * 8:
            eng.submit(s)
        phase_profile_path(Path(name, "rnl_fire_times_layer", eng.step,
                                lambda *_: {}))


def served_stacks(dev, streams, ff, p_ff):
    """Each served layer's config, gathered ``(C, B, rf)`` volleys and int32
    weights at the first volley of 64 clients: the shapes the main path
    gives the bank."""
    x = torch.from_numpy(np.stack([s[0] for s in streams[:N_SLOTS]])).to(dev)
    stacks = []
    for lc, w in zip(ff.layers, p_ff):
        times = layer._gather_rf(x, lc).contiguous()
        stacks.append((lc, times, torch.round(w).to(torch.int32)))
        out, _ = layer._fire_and_inhibit(w, times, lc)
        x = out.reshape(out.shape[0], lc.n_outputs)
    return stacks


def mesh_replicated(dev, streams, ff, p_ff) -> None:
    """A column count that the ``column`` axis does not divide, on the card:
    each served layer's stack through ``fire_times_bank`` on ``fused`` and
    ``fused_compact`` under a mesh whose column axis does not divide it
    (:data:`MESH_REPLICATED`, data split in two). The policy keeps the
    fused engine, the bank launches the unsharded kernel once on the
    rank's ``(C, B / 2, n)`` block (the sharded wrappers not at all), and
    the result equals the whole launch's rows bit for bit."""
    for (lc, times, w_int), (d, m) in zip(
            served_stacks(dev, streams, ff, p_ff), MESH_REPLICATED):
        shape = MeshShape({"data": d, "column": m})
        cfg = lc.neuron_config()
        rows = times.shape[1] // d
        for backend, inner in (("fused", "rnl_fire_times_layer"),
                               ("fused_compact", "rnl_fire_times_compact")):
            want = neuron.fire_times_bank(times, w_int, cfg,
                                          backend=backend)[:, :rows]
            torch.cuda.synchronize()
            reset_launches()
            rs.reset_launches()
            got = neuron.fire_times_bank(
                times[:, :rows].contiguous(), w_int, cfg, backend=backend,
                mesh=shape, shape=tuple(times.shape))
            torch.cuda.synchronize()
            counts = {k: v for k, v in mesh_counts().items() if v}
            if counts != {inner: 1} or not torch.equal(got, want):
                raise AssertionError(
                    f"replicated {lc.n_columns} columns on mesh ({d}, {m}) "
                    f"{backend}: launches {counts}, equal "
                    f"{torch.equal(got, want)}")
            emit("mesh", run="replicated", layer_columns=lc.n_columns,
                 mesh=[d, m], backend=backend, block=list(got.shape),
                 launches=counts, bit_exact=True)


def mesh_tiles(dev, streams, ff, p_ff) -> Dict[str, Dict[str, Any]]:
    """Every rank's tile of the served network's L1 and L2 stacks (the
    shapes the main path gives the wrappers: the first volley of 64
    clients) launched one after another through each sharded wrapper, for
    the (1, 1) mesh and every m-way column by d-way data mesh: the tiles
    put back together must equal the whole launch bit for bit, and the
    (1, 1) launch its plain version. One tile of each shape is timed
    (device ms by the profiler, per recorded launch: :func:`launch_device_ms`;
    call ms by CUDA events, the wrapper's host work included) beside its
    int32 bound. Returns, per wrapper, its row at L1 on the (1, 1) mesh (the main
    path's launch at world size 1) with every tile's times."""
    stacks = served_stacks(dev, streams, ff, p_ff)
    rows: Dict[str, Dict[str, Any]] = {}
    for wrapper in MESH_REPLACES:
        fn = getattr(rs, wrapper)
        plain = getattr(rs, wrapper + "_plain")
        compact = wrapper == "rnl_fire_times_compact_sharded"
        tiles = []
        for li, (lc, times, w_int) in enumerate(stacks):
            kw = dict(t_steps=lc.t_steps, threshold=lc.threshold,
                      k=neuron.clip_k(lc.neuron_config()))
            want = rn.rnl_fire_times_layer(times, w_int, **kw)
            t_in, w_in = times, w_int
            if compact:
                comp = compaction.compact_volleys(times, lc.t_steps)
                t_in = comp.times.contiguous()
                w_in = compaction.gather_weights(
                    w_int, comp.line_index).contiguous()
            whole = tuple(t_in.shape)
            for d, m in [(1, 1)] + [(d, m) for m in MESH_COLUMNS
                                    for d in MESH_DATA]:
                shape = MeshShape({"data": d, "column": m})
                nc, nb = whole[0] // m, whole[1] // d
                blocks = [[(t_in[i * nc:(i + 1) * nc,
                                 j * nb:(j + 1) * nb].contiguous(),
                            (w_in[i * nc:(i + 1) * nc, j * nb:(j + 1) * nb]
                             if compact else
                             w_in[i * nc:(i + 1) * nc]).contiguous())
                           for i in range(m)] for j in range(d)]
                got = torch.cat([torch.cat(
                    [fn(t, w, **kw, mesh=shape, shape=whole)
                     for t, w in row], dim=0) for row in blocks], dim=1)
                torch.cuda.synchronize()
                err = int((got.to(torch.int64) - want.to(torch.int64))
                          .abs().max())
                if err or got.shape != want.shape:
                    raise AssertionError(f"{wrapper} L{li + 1} mesh "
                                         f"({d}, {m}): the tiles differ from "
                                         f"the whole launch (max |err| "
                                         f"{err})")
                t, w = blocks[0][0]

                def call(t=t, w=w, shape=shape):
                    return fn(t, w, **kw, mesh=shape, shape=whole)

                fire = call()
                ms, recorded = launch_device_ms(call)
                call_ms = time_ms(call)
                bound, bound_by = bound_ms(t, w, fire, None, kw["t_steps"],
                                           kw["threshold"])
                tile = dict(wrapper=wrapper, layer=li + 1, mesh=[d, m],
                            tiles=d * m, tile_times=list(t.shape),
                            tile_weights=list(w.shape), max_abs_err=err,
                            ms=ms, ms_source="profiler, per recorded launch",
                            launches_recorded=recorded, kernels_per_call=1,
                            call_ms=call_ms, bound_ms=bound,
                            bound_by=bound_by)
                if (d, m) == (1, 1):
                    want_plain = plain(t, w, **kw, mesh=shape, shape=whole)
                    if not torch.equal(fire, want_plain):
                        raise AssertionError(f"{wrapper} L{li + 1}: the "
                                             f"kernel disagrees with its "
                                             f"plain version")
                    tile["plain_ms"] = time_ms(
                        lambda: plain(t, w, **kw, mesh=shape, shape=whole),
                        reps=5, warmup=1)
                emit("mesh_tiles", **tile)
                tiles.append(tile)
        rows[wrapper] = dict(tiles[0], tiles=[
            {k: tile[k] for k in ("layer", "mesh", "tile_times", "ms",
                                  "call_ms", "bound_ms")} for tile in tiles])
    return rows


def phase_mesh(dev, streams, ff, p_ff, served, single, root
               ) -> Tuple[Dict[str, Dict[str, int]], Dict[str, Dict[str, Any]]]:
    """The TNN stack across GPUs, on the one card: an NCCL process group of
    world size 1 and its ``(1, 1)`` ``("data", "column")`` mesh
    (``specs.tnn_mesh``); ``tnn_mesh(2, 1)`` must refuse one card. Then
    :func:`mesh_runs`, :func:`mesh_wall`, :func:`mesh_profiles`,
    :func:`mesh_replicated` and :func:`mesh_tiles`. The
    process group is destroyed before the LM phases. Returns the runs'
    launch counts and the wrappers' rows."""
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", init_method=(pathlib.Path(root) / "rendezvous").as_uri(),
        rank=0, world_size=1, timeout=datetime.timedelta(minutes=2))
    try:
        mesh = specs.tnn_mesh()
        if tuple(mesh.shape) != (1, 1) or mesh.device_type != "cuda" \
                or dist.get_backend() != "nccl":
            raise AssertionError(f"mesh {tuple(mesh.shape)} on "
                                 f"{mesh.device_type}, backend "
                                 f"{dist.get_backend()}")
        try:
            specs.tnn_mesh(2, 1)
        except ValueError as e:
            refused = str(e)
        else:
            raise AssertionError("tnn_mesh(2, 1) did not refuse one card")
        emit("mesh", run="setup", backend=dist.get_backend(),
             world_size=dist.get_world_size(), mesh=list(mesh.shape),
             dims=list(mesh.mesh_dim_names),
             nccl=".".join(map(str, torch.cuda.nccl.version())),
             tnn_mesh_2_1_refused=refused)
        launches = mesh_runs(dev, mesh, streams, ff, p_ff, served, single,
                             root)
        mesh_wall(dev, mesh, streams, ff, p_ff)
        mesh_profiles(dev, mesh, streams, ff, p_ff)
        mesh_replicated(dev, streams, ff, p_ff)
        rows = mesh_tiles(dev, streams, ff, p_ff)
    finally:
        dist.destroy_process_group()
    return launches, rows


def phase_lm_prefill(cfg, params, tokens, name="lm_prefill_time", **extra):
    """Host clock around whole prefill forwards, each ended by a
    synchronise: ms per forward (median of 3) and prefill tokens/s (text
    tokens; ``extra``: the patches or frames, passed to ``forward``)."""
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lm.forward(params, cfg, tokens, logits_mode="last", **extra)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    ms = statistics.median(times)
    emit(name, batch=int(tokens.shape[0]),
         seq=int(tokens.shape[1]), forward_ms=ms, forward_ms_all=times,
         tokens_per_s=tokens.numel() / (ms / 1e3))


def phase_profile_decode(cfg, params, prompts, run="lm_decode_step",
                         per_slot=False, frames=None):
    """Where a generation step's time goes: 4 warm ``decode_step`` calls
    for the prompts' batch under the profiler (busy, idle share, top
    device ops), with per-slot cache positions when ``per_slot`` (and the
    audio family's ``frames`` encoded first, outside the profile)."""
    steps = 4
    state = lm.init_serve_state(params, cfg, len(prompts), 256,
                                frames=frames)
    if per_slot:
        state = lm.per_slot_state(state, len(prompts))
    first = np.array([[p[0]] for p in prompts], np.int32)
    _, state = lm.decode_step(params, cfg, state, first)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, state = lm.decode_step(params, cfg, state, first)
        logits.float().cpu()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    emit("profile", run=run, steps=steps, batch=len(prompts),
         **device_share(device_events(prof), wall_ms))


def _map(tree, fn):
    """The parameter tree with ``fn`` applied to every leaf."""
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _over_scale(got, want):
    """max |got - want| over max |want|, in want's precision or float32."""
    f = torch.promote_types(want.dtype, torch.float32)
    return float((got.to(f) - want.to(f)).abs().max() / want.to(f).abs().max())


def _forward_vs_decode(cfg, params, tokens):
    """``forward`` and ``decode_step`` fed ``tokens`` (1, S) token by token.
    Returns both logits (1, S, V) and per layer max |difference| over max
    |output| for the Mamba2 block alone: the block's full-sequence form
    (the SSD kernel) applied to the inputs the decode fed that layer,
    against the decode's outputs (the recurrence), so that no layer sees
    another's difference."""
    fwd, _ = lm.forward(params, cfg, tokens)
    calls = []
    apply = lm.S.ssm_apply

    def spy(p, u, c, **kw):
        out = apply(p, u, c, **kw)
        calls.append((u, out[0]))
        return out

    state = lm.init_serve_state(params, cfg, tokens.shape[0], tokens.shape[1])
    dec = []
    lm.S.ssm_apply = spy
    try:
        for i in range(tokens.shape[1]):
            logits, state = lm.decode_step(params, cfg, state,
                                           tokens[:, i:i + 1])
            dec.append(logits)
    finally:
        lm.S.ssm_apply = apply
    per_layer = []
    n = cfg.n_layers
    for layer in range(n):
        ins, outs = (torch.cat([calls[t * n + layer][j]
                                for t in range(tokens.shape[1])], dim=1)
                     for j in (0, 1))
        full, _ = apply(lm._layer(params["layers"], layer)["ssm"], ins, cfg)
        per_layer.append(_over_scale(full, outs))
    return fwd, torch.stack(dec, dim=1), per_layer


#: forward-vs-decode gates, as fractions of the output's scale: each
#: layer's block in float32 and in bf16, and the float32 logits after all
#: 48 layers
LAYER_TOL_F32, LAYER_TOL_BF16, LOGITS_TOL_F32 = 1e-3, 2e-2, 3e-3


def phase_lm_checks(dev, cfg, params, tokens, prompts):
    """Cross-checks of the LM path at full width and depth, with TF32 off.

    (1) The SSD kernel against the recurrence: the forward over the first
    128 positions of one sequence against ``decode_step`` fed token by
    token, in a float32 copy of the model (the bf16 weights, upcast) and in
    bf16. Each layer's block, given the same inputs, must agree within 1e-3
    of its output's scale in float32 and 2e-2 in bf16; the float32 logits
    within 3e-3. The bf16 logits are reported, not held: a random 48-layer
    model carries each layer's rounding difference into the next and
    amplifies it with depth. As a witness, the same bf16 forward with the
    SSD scan's plain version on the card is held against the same decode.
    (2) The float32 engine's greedy tokens against the argmax of the
    float32 forward over prompt + output (teacher forcing); a mismatch is
    allowed only where the forward's logit of the engine's token lies
    within 3e-3 of the logits' scale of its maximum (the end-to-end
    tolerance of (1)), and is counted. (3) The card's float32 prefill
    against the CPU's plain forward in float64 at full width with depth
    cut to 2 layers, L = 256, ``logits_mode="last"``, within 1e-4 of the
    scale."""
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = _map(params, lambda t: t.float())
    head = tokens[:1, :128]
    fwd32, dec32, layers32 = _forward_vs_decode(cfg32, p32, head)
    fwd16, dec16, layers16 = _forward_vs_decode(cfg, params, head)
    logits32, logits16 = _over_scale(dec32, fwd32), _over_scale(dec16, fwd16)
    kernel = ss._ssd_scan
    ss._ssd_scan = ss._ssd_scan_plain
    try:
        plain16, _ = lm.forward(params, cfg, head)
    finally:
        ss._ssd_scan = kernel
    if not (max(layers32) <= LAYER_TOL_F32 and max(layers16) <= LAYER_TOL_BF16
            and logits32 <= LOGITS_TOL_F32):
        raise AssertionError(f"lm: forward vs decode: f32 logits {logits32}, "
                             f"worst layer f32 {max(layers32)}, bf16 "
                             f"{max(layers16)}")

    eng = Engine(p32, cfg32, ServeConfig(), device=dev)
    outs = eng.generate(prompts, max_new_tokens=NEW_TOKENS)
    width = max(len(p) for p in prompts)
    seq = np.full((len(prompts), width + NEW_TOKENS - 1), eng._fill,
                  np.int32)
    for r, (p, o) in enumerate(zip(prompts, outs)):
        seq[r, :len(p)] = p
        seq[r, width:width + len(o) - 1] = o[:-1]
    logits, _ = lm.forward(p32, cfg32, torch.from_numpy(seq).to(dev))
    logits = logits[:, width - 1:].float().cpu()
    checked, near_ties = 0, 0
    for r, o in enumerate(outs):
        for i, t in enumerate(o):
            row = logits[r, i]
            top = int(row.argmax())
            checked += 1
            if top != int(t):
                gap = float(row[top] - row[int(t)])
                if gap > LOGITS_TOL_F32 * float(row.abs().max()):
                    raise AssertionError(
                        f"lm: greedy token {i} of request {r} is {int(t)}, "
                        f"the f32 forward's argmax {top} (gap {gap})")
                near_ties += 1

    cfg2 = dataclasses.replace(cfg32, n_layers=2)
    p2 = {**p32, "layers": _map(p32["layers"], lambda t: t[:2])}
    toks2 = tokens[:2, :256]
    card, _ = lm.forward(p2, cfg2, toks2, logits_mode="last")
    host, _ = lm.forward(_map(p2, lambda t: t.cpu().double()), cfg2,
                         toks2.cpu(), logits_mode="last")
    card_cpu = _over_scale(card.cpu(), host)
    if host.dtype != torch.float64 or not card_cpu <= 1e-4:
        raise AssertionError(f"lm: card vs CPU float64 forward {card_cpu}")
    emit("lm_checks", tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         tf32_cudnn=torch.backends.cudnn.allow_tf32,
         positions=int(head.shape[1]),
         forward_vs_decode=dict(
             float32=dict(logits=logits32, worst_layer=max(layers32),
                          layers=layers32),
             bfloat16=dict(logits=logits16, worst_layer=max(layers16),
                           layers=layers16,
                           plain_scan_logits=_over_scale(dec16, plain16),
                           kernel_vs_plain_logits=_over_scale(fwd16,
                                                              plain16)),
             layer_tol=dict(float32=LAYER_TOL_F32, bfloat16=LAYER_TOL_BF16),
             logits_tol=dict(float32=LOGITS_TOL_F32)),
         greedy_vs_forward=dict(tokens=checked, near_ties=near_ties,
                                equal=checked - near_ties),
         card_vs_cpu=dict(layers=2, batch=int(toks2.shape[0]),
                          seq=int(toks2.shape[1]), logits_mode="last",
                          card_dtype="float32", host_dtype="float64",
                          max_err_over_scale=card_cpu, tol=1e-4))


#: moe checks, as fractions of the output's scale (float32): each MLA
#: block's full-sequence form against its cached decode; a 2-layer
#: model's forward logits against its token-by-token decode; the card's
#: 1-layer forward against the CPU's float64 one
MLA_TOL_F32, MOE_LOGITS_TOL_F32, MOE_CARD_CPU_TOL = 1e-5, 1e-4, 1e-4


def _cut_f32(params, n_layers: int, n_encoder: int = 0):
    """A float32 copy of ``params`` with the first ``n_layers`` layers
    (and ``n_encoder`` encoder layers)."""
    out = {}
    for k, v in params.items():
        if k in ("layers", "encoder"):
            n = n_layers if k == "layers" else n_encoder
            out[k] = _map(v, lambda t, n=n: t[:n].float())
        elif isinstance(v, dict):
            out[k] = _map(v, lambda t: t.float())
        else:
            out[k] = v.float()
    return out


def phase_moe_checks(dev, cfg, params):
    """Cross-checks of the MoE path at full width in float32 (copies of the
    bf16 weights, upcast), TF32 off.

    (1) Each of the 27 layers' MLA block on identical inputs (1 x 64
    random positions): the full-sequence form against its cached decode
    fed token by token, within 1e-5 of the output's scale. (2) A 2-layer
    model's forward logits (1 x 32 tokens) against its token-by-token
    decode, within 1e-4 of the logits' scale, with ``capacity_factor =
    E/k``: then cap = t at every T (32 at the forward, 1 at a decode step),
    so no assignment drops on either side; at the model's own factor the
    forward (cap 6 for 32 tokens) drops where the decode (cap 1 for one
    token) cannot, which is the reference's semantics, not a fault. (3) The card's 1-layer
    forward (B = 1, S = 64, ``logits_mode="last"``; capacity 7 of 64, so
    drops happen alike) against the CPU's plain forward in float64, within
    1e-4 of the scale."""
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    rng = np.random.default_rng(9)
    seq = 64
    h = torch.from_numpy(rng.standard_normal(
        (1, seq, cfg.d_model)).astype(np.float32)).to(dev)
    mla = []
    for i in range(cfg.n_layers):
        p = _map(lm._layer(params["layers"], i)["attn"], lambda t: t.float())
        full, _ = lm.A.mla_apply(p, h, cfg32)
        cache = lm.A.mla_cache_init(cfg32, 1, seq, torch.float32, dev)
        steps = []
        for t in range(seq):
            out, cache = lm.A.mla_apply(p, h[:, t:t + 1], cfg32, cache=cache)
            steps.append(out)
        mla.append(_over_scale(torch.cat(steps, dim=1), full))
    if not max(mla) <= MLA_TOL_F32:
        raise AssertionError(f"moe: MLA full sequence vs cached decode "
                             f"{max(mla)} of scale")

    e, k = cfg.moe.n_experts, cfg.moe.top_k
    cfg2 = dataclasses.replace(cfg32, n_layers=2, moe=dataclasses.replace(
        cfg.moe, capacity_factor=e / k))
    p2 = _cut_f32(params, 2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 32))).to(dev)
    for t in (1, toks.shape[1]):
        if lm.M._capacity(t, cfg2.moe) != t:
            raise AssertionError(f"moe: capacity at T={t} is not T")
    fwd, _ = lm.forward(p2, cfg2, toks)
    state = lm.init_serve_state(p2, cfg2, 1, toks.shape[1])
    dec = []
    for t in range(toks.shape[1]):
        logits, state = lm.decode_step(p2, cfg2, state, toks[:, t:t + 1])
        dec.append(logits)
    fwd_dec = _over_scale(torch.stack(dec, dim=1), fwd)
    del p2, fwd, state, dec
    if not fwd_dec <= MOE_LOGITS_TOL_F32:
        raise AssertionError(f"moe: 2-layer forward vs decode {fwd_dec}")

    cfg1 = dataclasses.replace(cfg32, n_layers=1)
    p1 = _cut_f32(params, 1)
    toks1 = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 64))).to(dev)
    card, _ = lm.forward(p1, cfg1, toks1, logits_mode="last")
    host, _ = lm.forward(_map(p1, lambda t: t.cpu().double()), cfg1,
                         toks1.cpu(), logits_mode="last")
    card_cpu = _over_scale(card.cpu(), host)
    if host.dtype != torch.float64 or not card_cpu <= MOE_CARD_CPU_TOL:
        raise AssertionError(f"moe: card vs CPU float64 forward {card_cpu}")
    emit("moe_checks", arch=cfg.name,
         tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         mla_full_vs_decode=dict(positions=seq, worst_layer=max(mla),
                                 layers=mla, tol=MLA_TOL_F32),
         forward_vs_decode=dict(layers=2, tokens=int(toks.shape[1]),
                                capacity_factor=e / k,
                                max_err_over_scale=fwd_dec,
                                tol=MOE_LOGITS_TOL_F32),
         card_vs_cpu=dict(layers=1, batch=1, seq=int(toks1.shape[1]),
                          logits_mode="last", card_dtype="float32",
                          host_dtype="float64", max_err_over_scale=card_cpu,
                          tol=MOE_CARD_CPU_TOL))


# ================================================== LM across GPUs

#: the expert-parallel tiles: every rank's part of an m-way model by d-way
#: data mesh, launched one after another on the one card
LM_MESH_MODEL, LM_MESH_DATA = (2, 4, 8), (1, 2)
#: the tiles' summed parts against ``moe_apply`` at a drop-free capacity
#: (factor E/k: every expert may take every token), bf16: max |err| over
#: the output's largest |value|. Each rank rounds its part to bf16 and the
#: parts are summed in bf16 (the all-reduce's dtype), where the whole
#: layer rounds once: a few bf16 roundings of the output, well under 2^-5
EP_TILE_TOL = 2.0 ** -5
#: the smoke-size mesh train step (deepseek-v2-lite ``--opt``): the
#: launcher's smoke dtype, 3 steps of 8 x 64 tokens in 2 microbatches,
#: compression rho 0.1
LM_MESH_STEPS, LM_MESH_BATCH, LM_MESH_SEQ, LM_MESH_ACCUM = 3, 8, 64, 2


def _moe_input(params, cfg, tokens):
    """The first MoE layer's parameters and its input on ``tokens``,
    (T, D): layer 0's block up to its second norm (the MLA attention and
    the residual), as ``transformer._block_apply`` computes it."""
    lp = lm._layer(params["layers"], 0)
    x = lm.L.embed_lookup(params["embed"], tokens)
    h = lm.L.rmsnorm(lp["norm1"], x, cfg.norm_eps)
    a, _ = lm.A.mla_apply(lp["attn"], h, cfg)
    _, h = lm._residual_norm(lp["norm2"], x, a, cfg)
    return lp["moe"], h.reshape(-1, cfg.d_model)


def _tile_params(p, i: int, m: int):
    """Model rank ``i`` of ``m``'s blocks of one MoE layer (its experts,
    its slice of the shared experts' d_ff, the router whole) and its
    expert count."""
    e_loc = p["w_gate"].shape[0] // m
    loc = {"router": p["router"],
           **{k: p[k][i * e_loc:(i + 1) * e_loc]
              for k in ("w_gate", "w_up", "w_down")}}
    if "shared" in p:
        sh = p["shared"]
        fs = sh["w_gate"].shape[1] // m
        loc["shared"] = {"w_gate": sh["w_gate"][:, i * fs:(i + 1) * fs],
                         "w_up": sh["w_up"][:, i * fs:(i + 1) * fs],
                         "w_down": sh["w_down"][i * fs:(i + 1) * fs]}
    return loc, e_loc


def _drops(idx, e: int, cap: int) -> int:
    """Assignments past their expert's capacity ``cap``."""
    counts = torch.bincount(idx.reshape(-1).long(), minlength=e)
    return int(torch.clamp(counts - cap, min=0).sum())


def lm_mesh_tiles(cfg, p, xt) -> None:
    """Every rank's part of the expert-parallel layer (``moe._local_dispatch_ffn``)
    for each m-way model by d-way data tiling of the first MoE layer on the
    prefill's tokens, launched one after another: each data block's model
    parts summed and the blocks put together, at a drop-free capacity,
    against ``moe_apply`` on all the tokens (:data:`EP_TILE_TOL`). At the
    ``--opt`` capacity (1.0) each tiling's drops (the local capacity of
    each data block) beside the whole layer's, one tile's gate launches
    (one a tile), its time (CUDA events) and its gate's device time
    (profiler); each data block size's gate call held against its plain
    version."""
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    free = dataclasses.replace(cfg.moe, capacity_factor=e / k)
    want = lm.M.moe_apply(p, xt[None], free)[0][0].float()
    scale = float(want.abs().max())
    t = xt.shape[0]
    whole_drops = _drops(lm.M._route(p, xt, cfg.moe)[2], e,
                         lm.M._capacity(t, cfg.moe))
    for d in LM_MESH_DATA:
        logits = lm.L._f32(xt[:t // d]) @ p["router"]
        check_gate(f"lm_mesh_tile/T{t // d}", logits, k, True, timed=False,
                   path="lm_mesh_tiles", calls=1)
    for m in LM_MESH_MODEL:
        for d in LM_MESH_DATA:
            n = t // d
            blocks, drops = [], 0
            for j in range(d):
                x_j = xt[j * n:(j + 1) * n]
                acc = None
                for i in range(m):
                    loc, e_loc = _tile_params(p, i, m)
                    part, _ = lm.M._local_dispatch_ffn(loc, x_j, free,
                                                       i * e_loc, e_loc)
                    acc = part if acc is None else acc + part
                blocks.append(acc)
                drops += _drops(lm.M._route(p, x_j, cfg.moe)[2], e,
                                lm.M._capacity(n, cfg.moe))
            err = float((torch.cat(blocks).float() - want).abs().max()) \
                / scale
            if not err <= EP_TILE_TOL:
                raise AssertionError(f"lm_mesh tiles ({d}, {m}): the parts "
                                     f"differ from moe_apply by {err} of "
                                     f"scale")
            loc, e_loc = _tile_params(p, 0, m)
            x0 = xt[:n]

            def tile(loc=loc, e_loc=e_loc, x0=x0):
                return lm.M._local_dispatch_ffn(loc, x0, cfg.moe, 0, e_loc)
            mg.reset_launches()
            tile()
            torch.cuda.synchronize()
            per_tile = mg.LAUNCHES["moe_gate_topk"]
            if per_tile != 1:
                raise AssertionError(f"lm_mesh tile: {per_tile} gate "
                                     f"launches")
            gate_ms, _ = kernel_ms(tile, reps=5, key="moe_gate")
            emit("lm_mesh_tiles", mesh=[d, m], tiles=d * m,
                 tokens_per_tile=n, experts_per_tile=e_loc,
                 drop_free_max_err_over_scale=err, tol=EP_TILE_TOL,
                 capacity_factor=cfg.moe.capacity_factor,
                 tile_capacity=lm.M._capacity(n, cfg.moe), drops=drops,
                 whole_layer_drops=whole_drops, assignments=t * k,
                 gate_launches_per_tile=per_tile,
                 tile_ms=time_ms(tile, reps=5, warmup=1),
                 gate_ms=gate_ms, gate_ms_source="profiler")
            del blocks


def lm_plain_tiles(cfg, p, xt, mesh) -> None:
    """Every rank's part of the plain MoE layer under a mesh
    (``moe._plain_part``: its experts over ``model``, their d_ff over the
    data axis, the capacity and the drops the whole batch's) for each
    m-way model by d-way data tiling of the first MoE layer on the
    prefill's tokens, through ``_plain_part``'s rank stages launched one
    after another and combined as its collectives would: each part routes
    its rows (``_route``, one gate launch), the ids of every part make the
    batch's relocation (``_relocation``), the data parts' rows fill each
    model rank's slots (``_fill_slots``, summed), each part runs its
    experts' d_ff block (``_expert_ffn``, summed over the data parts), and
    each part's float32 combine of its rows from its experts
    (``_rows_combine``) is summed over the model ranks and rounded once,
    the whole shared experts added. Each part holds E / m experts; the
    parts against ``moe_apply`` on all the tokens within
    :data:`EP_TILE_TOL` of scale (bf16); the parts' drops summed equal to
    the whole layer's; each data block size's gate call held against its
    plain version. ``_plain_part`` itself, on the world-size-1 ``mesh``
    with every expert (its collectives the identity), equals ``moe_apply``
    bit for bit in its output and within float32 rounding in its aux
    loss, with one gate launch."""
    M = lm.M
    e, k, f = cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.d_expert
    t, d_model = xt.shape
    want, want_aux = M.moe_apply(p, xt[None], cfg.moe)
    mg.reset_launches()
    got, got_aux = M._plain_part(p, xt[None], cfg.moe, mesh, ())
    torch.cuda.synchronize()
    aux_err = abs(float(got_aux["aux_loss"]) - float(want_aux["aux_loss"]))
    if not torch.equal(got, want) or mg.LAUNCHES["moe_gate_topk"] != 1 \
            or not aux_err <= 1e-6 * abs(float(want_aux["aux_loss"])):
        raise AssertionError(
            f"lm_plain _plain_part at world size 1: output equal "
            f"{torch.equal(got, want)}, aux off by {aux_err}, "
            f"{mg.LAUNCHES['moe_gate_topk']} gate launches")
    emit("lm_plain_part", mesh=list(mesh.shape), tokens=t, experts=e,
         bit_exact_vs_moe_apply=True, aux_abs_err=aux_err,
         gate_launches=1)
    del got
    want = want[0].float()
    scale = float(want.abs().max())
    cap = M._capacity(t, cfg.moe)
    whole_drops = _drops(M._route(p, xt, cfg.moe)[2], e, cap)
    for d in LM_MESH_DATA:
        logits = lm.L._f32(xt[:t // d]) @ p["router"]
        check_gate(f"lm_plain_tile/T{t // d}", logits, k, True, timed=False,
                   path="lm_plain_tiles", calls=1)
    for m in LM_MESH_MODEL:
        for d in LM_MESH_DATA:
            n, e_loc, f_loc = t // d, e // m, f // d
            stand_in = StandInMesh(d, m)
            block = {name: specs.block_shape(p[name].shape, spec, stand_in)
                     for name, spec in M.plain_block_specs(
                         cfg.moe, stand_in).items()}
            rows = [xt[j * n:(j + 1) * n] for j in range(d)]
            mg.reset_launches()
            routes = [M._route(p, x_j, cfg.moe) for x_j in rows]
            torch.cuda.synchronize()
            per_part = mg.LAUNCHES["moe_gate_topk"] / d
            ids = torch.cat([r[2] for r in routes])
            routed = [torch.zeros((n, d_model), dtype=torch.float32,
                                  device=xt.device) for _ in range(d)]
            drops = 0
            for i in range(m):
                e_lo = i * e_loc
                slot_src, token_slot = M._relocation(ids, cap, e_lo, e_loc)
                drops += int(((ids >= e_lo) & (ids < e_lo + e_loc)).sum()
                             - (slot_src < t).sum())
                expert_in = sum(M._fill_slots(x_j, slot_src, j * n)
                                for j, x_j in enumerate(rows))
                expert_out = 0
                for j in range(d):
                    part = {name: p[name][e_lo:e_lo + e_loc]
                            for name in ("w_gate", "w_up", "w_down")}
                    fs = slice(j * f_loc, (j + 1) * f_loc)
                    part = {"w_gate": part["w_gate"][:, :, fs],
                            "w_up": part["w_up"][:, :, fs],
                            "w_down": part["w_down"][:, fs]}
                    if {name: tuple(w.shape) for name, w in part.items()} \
                            != block:
                        raise AssertionError(f"lm_plain tile: part "
                                             f"blocks, the rule's {block}")
                    expert_out = expert_out + M._expert_ffn(
                        part, expert_in.reshape(e_loc, cap, d_model))
                for j in range(d):
                    routed[j] += M._rows_combine(expert_out, token_slot,
                                                 routes[j][1], j * n)
            out = torch.cat([r.to(xt.dtype) + lm.L.mlp_apply(p["shared"], x_j)
                             for r, x_j in zip(routed, rows)])
            err = float((out.float() - want).abs().max()) / scale
            if not err <= EP_TILE_TOL or drops != whole_drops \
                    or per_part != 1:
                raise AssertionError(
                    f"lm_plain tiles ({d}, {m}): error {err} of scale, "
                    f"drops {drops} against {whole_drops}, {per_part} gate "
                    f"launches a part")
            emit("lm_plain_tiles", mesh=[d, m], parts=d * m,
                 tokens_per_part=n, experts_per_part=e_loc,
                 d_ff_per_part=f_loc, capacity=cap,
                 capacity_factor=cfg.moe.capacity_factor,
                 max_err_over_scale=err, tol=EP_TILE_TOL, drops=drops,
                 whole_layer_drops=whole_drops, assignments=t * k,
                 gate_launches_per_part=per_part)


def lm_mesh_train(dev, mesh) -> Dict[str, Dict[str, int]]:
    """The mesh train step at world size 1 (``make_train_step(...,
    mesh=)`` on blocks cut by ``state_pspecs``) against the single-device
    step on the card, from the same state and batches: deepseek-v2-lite
    ``--opt`` (``catwalk_ep``) at the smoke size (its f32 moments do not
    fit one card at full size), :data:`LM_MESH_STEPS` steps; every metric
    and every leaf of the gathered state bit for bit. internlm2 and
    mamba2 run the mesh step at full width in the training phase
    (:func:`lm_mesh_train_full`). Returns the mesh run's launch counts."""
    out = {}
    for arch, opt in ((TRAIN_MOE, True), (TRAIN_MOE, False)):
        cfg = lm_registry.get_config(arch + "-smoke")
        if opt:
            cfg = dryrun.apply_opt(cfg)
        tcfg = TL.TrainConfig(
            optimizer=O.AdamWConfig(lr=CHECK_LR, warmup_steps=2,
                                    total_steps=50),
            grad_accum=LM_MESH_ACCUM,
            compression=GC.CompressionConfig(rho=0.1))
        state = TL.init_train_state(torch.Generator(device=dev).manual_seed(
            3), cfg, tcfg, device=dev)
        st = TL.state_pspecs(cfg, tcfg, mesh)
        blocks = specs.shard_tree(state, st, mesh)
        data = DP.SyntheticLM(DP.DataConfig(
            seq_len=LM_MESH_SEQ, global_batch=LM_MESH_BATCH,
            vocab_size=cfg.vocab_size))
        single = TL.make_train_step(cfg, tcfg)
        step = TL.make_train_step(cfg, tcfg, mesh=mesh)
        want = []
        for i in range(LM_MESH_STEPS):
            state, m = single(state, data.batch(i))
            want.append({k: float(v) for k, v in m.items()})
        reset_launches()
        got = []
        for i in range(LM_MESH_STEPS):
            blocks, m = step(blocks, data.batch(i))
            got.append({k: float(v) for k, v in m.items()})
        torch.cuda.synchronize()
        counts = launch_counts()
        whole = specs.gather_tree(blocks, st, mesh)
        same = got == want and all(
            torch.equal(a, b) for a, b in zip(
                tree_leaves(whole.params) + tree_leaves(whole.opt.m)
                + tree_leaves(whole.ef.error),
                tree_leaves(state.params) + tree_leaves(state.opt.m)
                + tree_leaves(state.ef.error)))
        if not same:
            raise AssertionError(f"lm_mesh train {arch}: the mesh step "
                                 f"differs from the single-device step "
                                 f"({got} vs {want})")
        name = f"lm_mesh_train_{arch.split('-')[0]}" + (
            "" if opt else "_plain")
        emit("lm_mesh", run=name, arch=cfg.name, opt=opt, dtype=cfg.dtype,
             dispatch=cfg.moe.dispatch if cfg.moe else None,
             batch_over_model=cfg.batch_over_model, steps=LM_MESH_STEPS,
             grad_accum=LM_MESH_ACCUM, losses=[g["loss"] for g in got],
             bit_exact_vs_single=True,
             launches={k: v for k, v in counts.items() if v})
        out[name] = counts
    return out


#: the tensor-parallel tiles: every rank's part of one layer for these
#: model-axis sizes, launched one after another and combined as the
#: collectives would (partial outputs summed, the SSM norm's squares
#: summed before the ranks normalise); bf16 layers against the whole
#: layer within TP_TILE_TOL of its output's scale (each rank rounds its
#: part to bf16 and the parts add in bf16: a few bf16 roundings), the
#: vocabulary-parallel cross-entropy in float32 within CE_TILE_TOL
#: (relative) of the whole one
TP_TILE_MODEL = (2, 4, 8)
TP_TILE_TOL = 2.0 ** -5
CE_TILE_TOL = 1e-5
#: the tiles' input: B x S tokens (the prefill's 8,192), and the archs
DENSE_ARCH = "internlm2-1.8b"
TP_TILE_B, TP_TILE_S = 4, 2048
#: the spec-tree state sizes: archs and model-axis sizes (the launcher's
#: mesh is (1, world) up to 16)
TP_BYTES_ARCHS = (DENSE_ARCH, LM_ARCH, MOE_ARCH)
TP_BYTES_MODEL = (1, 2, 4, 8, 16)


class StandInMesh:
    """A ``("data", "model")`` mesh shape for the sharding rules, which
    read only a mesh's names and shape (no process group)."""

    def __init__(self, n_data: int, n_model: int):
        self.mesh_dim_names = ("data", "model")
        self.shape = (n_data, n_model)


def tp_bytes_lines() -> None:
    """Per arch and model-axis size, computed from the spec tree (nothing
    allocated, nothing measured): the state each rank holds at rest
    (parameters, AdamW moments, the error buffer of ``--compress``) and
    what the mesh step's forward gathers whole (every leaf
    ``transformer.tp_plan`` leaves out: their sum, held through the
    step, and the largest)."""
    def nbytes(t, spec, mesh):
        n = t.element_size()
        for d, e in zip(t.shape, spec):
            n *= d // specs.axis_size(mesh, e)
        return n

    for arch in TP_BYTES_ARCHS:
        cfg = lm_registry.get_config(arch)
        tcfg = TL.TrainConfig(compression=GC.CompressionConfig(rho=0.01))
        meta = TL.init_train_state(torch.Generator(), cfg, tcfg,
                                   device="meta")
        for m in TP_BYTES_MODEL:
            mesh = StandInMesh(1, m)
            st = specs._spec_table(TL.state_pspecs(cfg, tcfg, mesh))
            plan = specs._spec_table(lm.tp_plan(cfg, mesh))
            sizes = {"params": 0, "moments": 0, "ef": 0}
            gathers = []

            def leaf(key, t):
                spec = st[key]
                part = key.split("/", 1)[0]
                kind = {".params": "params", ".opt": "moments",
                        ".ef": "ef"}.get(part)
                if kind is None:
                    return t
                sizes[kind] += nbytes(t, spec, mesh)
                if kind == "params":
                    keep = plan[key[len(".params/"):]]
                    fetch = tuple(None if k is not None else e
                                  for e, k in zip(spec, keep))
                    if any(specs.axis_size(mesh, e) > 1 for e in fetch
                           if e is not None):
                        gathers.append(nbytes(t, keep, mesh))
                return t
            ckpt._map_with_path(meta, leaf)
            emit("tp_bytes", arch=arch, mesh=[1, m], source="spec tree",
                 params_bytes=sizes["params"],
                 moments_bytes=sizes["moments"], ef_bytes=sizes["ef"],
                 forward_gather_bytes=sum(gathers),
                 largest_gather_bytes=max(gathers, default=0),
                 gathered_leaves=len(gathers))


def _mlp_rank(p, i: int, m: int):
    f = p["w_gate"].shape[1] // m
    return {"w_gate": p["w_gate"][:, i * f:(i + 1) * f],
            "w_up": p["w_up"][:, i * f:(i + 1) * f],
            "w_down": p["w_down"][i * f:(i + 1) * f]}


def _tile_line(layer, m, got, want, tol, part, whole, shape, **extra):
    """Hold a tiling's combined output against the whole layer's (within
    ``tol`` of its scale), time rank 0's part and the whole layer (CUDA
    events), count rank 0's launches, and emit the line."""
    err = float((got.float() - want.float()).abs().max()) \
        / float(want.float().abs().max())
    if not err <= tol:
        raise AssertionError(f"lm_tp_tiles {layer} m={m}: the combined "
                             f"parts differ from the whole layer by "
                             f"{err} of scale")
    reset_launches()
    part()
    torch.cuda.synchronize()
    counts = {k: v for k, v in launch_counts().items() if v}
    emit("lm_tp_tiles", layer=layer, model=m, tiles=m, shape=shape,
         max_err_over_scale=err, tol=tol, launches_per_tile=counts,
         tile_ms=time_ms(part, reps=5, warmup=1),
         whole_ms=time_ms(whole, reps=5, warmup=1), ms_source="cuda_events",
         **extra)
    return err


def lm_tp_tiles(dev, cfg, params, tokens) -> Tuple[Dict[str, int],
                                                   List[Dict[str, Any]]]:
    """Every rank's part of one layer under tensor parallelism over an
    m-way ``model`` axis (m in TP_TILE_MODEL), launched one after another
    and combined as the collectives would: internlm2-1.8b's dense block
    (GQA by heads, the MLP by d_ff) and mamba2-780m's SSM block (the rank's
    heads: the SSD kernel once a tile on ``(4 * 48 / m, 2048, 64)``, the
    norm's squares summed over the ranks) at full width on random bf16
    weights and inputs, deepseek-v2-lite's first MLA attention on the
    prefill's hidden states, and the vocabulary-parallel cross-entropy
    over internlm2's 92,544-way head (float32). Each tiling against the
    whole layer. Returns the SSD launches of the combined runs (with the
    counts set to 0 just before and read just after) and the kernel rows
    of the SSD calls at the tile shapes (:func:`check_ssd`)."""
    gen = torch.Generator(device=dev).manual_seed(21)
    bf16 = torch.bfloat16

    def normal(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    dense = lm_registry.get_config(DENSE_ARCH)
    mamba = lm_registry.get_config(LM_ARCH)
    with torch.no_grad():
        # internlm2's dense block
        p = lm._block_init(gen, dense, bf16, dev)
        x = normal(TP_TILE_B, TP_TILE_S, dense.d_model)
        want = lm._block_apply(p, x, dense)[0]
        h = lm.L.rmsnorm(p["norm1"], x, dense.norm_eps)
        for m in TP_TILE_MODEL:
            def attn(i, m=m):
                return lm.A.gqa_apply(lm.A.gqa_rank_params(
                    p["attn"], dense, i, m), h, dense)[0]
            a = sum(attn(i) for i in range(m))
            x2, h2 = lm._residual_norm(p["norm2"], x, a, dense)
            out = sum(lm.L.mlp_apply(_mlp_rank(p["mlp"], i, m), h2)
                      for i in range(m))
            _tile_line("internlm2_block", m, x2 + out, want, TP_TILE_TOL,
                       lambda m=m, attn=attn, h2=h2: (
                           attn(0), lm.L.mlp_apply(_mlp_rank(p["mlp"], 0, m),
                                                   h2)),
                       lambda: lm._block_apply(p, x, dense),
                       [TP_TILE_B, TP_TILE_S, dense.d_model],
                       q_heads_per_tile=dense.n_heads // m,
                       kv_heads_per_tile=dense.n_kv_heads // m,
                       d_ff_per_tile=dense.d_ff // m)
        del p, x, want, h, a, x2, h2, out

        # deepseek-v2-lite's first MLA attention
        lp = lm._layer(params["layers"], 0)
        hm = lm.L.rmsnorm(lp["norm1"], lm.L.embed_lookup(params["embed"],
                                                          tokens),
                          cfg.norm_eps)
        want = lm.A.mla_apply(lp["attn"], hm, cfg)[0]
        for m in TP_TILE_MODEL:
            def mla(i, m=m):
                return lm.A.mla_apply(lm.A.mla_rank_params(
                    lp["attn"], cfg, i, m), hm, cfg)[0]
            _tile_line("deepseek_mla", m, sum(mla(i) for i in range(m)),
                       want, TP_TILE_TOL, lambda mla=mla: mla(0),
                       lambda: lm.A.mla_apply(lp["attn"], hm, cfg),
                       list(hm.shape), heads_per_tile=cfg.n_heads // m)
        del lp, hm, want

        # mamba2's SSM block: the SSD kernel on each rank's heads
        sp = {"norm1": lm.L.rmsnorm_init(mamba.d_model, dev),
              "ssm": lm.S.ssm_init(gen, mamba, bf16, dev)}
        sp["ssm"]["dt_bias"] = normal(sp["ssm"]["dt_bias"].shape[0],
                                      dtype=torch.float32) * 0.5
        sp["ssm"]["a_log"] = normal(sp["ssm"]["a_log"].shape[0],
                                    dtype=torch.float32) * 0.5
        x = normal(TP_TILE_B, TP_TILE_S, mamba.d_model)
        want = lm._ssm_block(x, sp, mamba)
        h = lm.L.rmsnorm(sp["norm1"], x, mamba.norm_eps)
        heads = mamba.ssm.n_heads(mamba.d_model)

        def ssm_tiles(m):
            ranks = [lm.S.ssm_rank_params(sp["ssm"], mamba, i, m)
                     for i in range(m)]
            ys = [lm.S.ssm_gated(pr, h, mamba)[0] for pr in ranks]
            sumsq = sum(torch.sum(y * y, dim=-1, keepdim=True) for y in ys)
            return x + sum(lm.S.ssm_project(pr, y, sumsq, mamba, bf16)
                           for pr, y in zip(ranks, ys))

        reset_launches()
        combined = {m: ssm_tiles(m) for m in TP_TILE_MODEL}
        torch.cuda.synchronize()
        counts = launch_counts()
        want_launches = sum(TP_TILE_MODEL)
        if counts["ssd_scan"] != want_launches or any(
                v for k, v in counts.items() if k != "ssd_scan"):
            raise AssertionError(f"lm_tp_tiles: {counts} launches, "
                                 f"{want_launches} SSD launches wanted")
        rows = []
        for m in TP_TILE_MODEL:
            pr0 = lm.S.ssm_rank_params(sp["ssm"], mamba, 0, m)

            def part(pr0=pr0):
                return lm.S.ssm_gated(pr0, h, mamba)
            _tile_line("mamba2_ssm", m, combined[m], want, TP_TILE_TOL,
                       part, lambda: lm._ssm_block(x, sp, mamba),
                       [TP_TILE_B, TP_TILE_S, mamba.d_model],
                       heads_per_tile=heads // m,
                       ssd_rows=[TP_TILE_B * heads // m, TP_TILE_S,
                                 mamba.ssm.head_dim])
            (case,) = capture(part, ssd_copies=1)
            rows.append(check_ssd(f"lm_tp_tiles/m{m}", *case["operands"][0],
                                  case["chunk"], case["heads"],
                                  path="lm_tp_tiles", calls=m, model=m))
        del sp, x, want, h, combined

        # the vocabulary-parallel cross-entropy over internlm2's head
        head = lm.L.dense_init(gen, dense.d_model, dense.vocab_size, bf16,
                               dev)
        x = lm.L.rmsnorm(torch.ones(dense.d_model, device=dev),
                         normal(TP_TILE_B, TP_TILE_S, dense.d_model),
                         dense.norm_eps)
        labels = torch.randint(0, dense.vocab_size, (TP_TILE_B, TP_TILE_S),
                               generator=gen, device=dev)
        logits = (x @ head).float()
        want = lm.L.cross_entropy(logits, labels)
        for m in TP_TILE_MODEL:
            v = dense.vocab_size // m
            blocks = [logits[..., i * v:(i + 1) * v] for i in range(m)]
            mx = torch.stack([lm.L.vocab_max(b) for b in blocks]).amax(0)
            se = sum(lm.L.vocab_sumexp(b, mx) for b in blocks)
            gold = sum(lm.L.vocab_gold(b, labels, i * v)
                       for i, b in enumerate(blocks))
            got = torch.mean(torch.log(se) + mx - gold)

            def part(v=v):
                block = (x @ head[:, :v]).float()
                mx0 = lm.L.vocab_max(block)
                return (lm.L.vocab_sumexp(block, mx0),
                        lm.L.vocab_gold(block, labels, 0))
            err = abs(float(got) - float(want)) / abs(float(want))
            if not err <= CE_TILE_TOL:
                raise AssertionError(f"lm_tp_tiles ce m={m}: {float(got)} "
                                     f"vs {float(want)}")
            emit("lm_tp_tiles", layer="internlm2_vocab_ce", model=m,
                 tiles=m, shape=[TP_TILE_B, TP_TILE_S, dense.vocab_size],
                 vocab_per_tile=v, loss=float(got), whole_loss=float(want),
                 rel_err=err, tol=CE_TILE_TOL, launches_per_tile={},
                 tile_ms=time_ms(part, reps=5, warmup=1),
                 whole_ms=time_ms(lambda: lm.L.cross_entropy(
                     (x @ head).float(), labels), reps=5, warmup=1),
                 ms_source="cuda_events")
        del head, x, logits
    gc.collect()
    torch.cuda.empty_cache()
    return counts, rows


#: the mesh decode: DECODE_STEPS steps of decode_step(..., mesh=) after a
#: prefill of the phase's 4 x 2,048 tokens, each step's tokens drawn from
#: a seed; the caches hold DECODE_STEPS positions past the prefill
DECODE_STEPS = 16


def prefilled_state(params, cfg, tokens, max_len: int):
    """The serve state after a prefill of ``tokens`` (B, S): one
    ``forward`` over them with each layer's mixer input captured, and the
    caches written from those inputs as the decode would write them token
    by token — GQA's roped K and V (the hybrid's: each shared-block
    site's), MLA's latent and roped rotary key, the Mamba2 conv window
    (the last K - 1 conv inputs) and SSD state (the scan's inputs summed
    under their decays: the recurrence's final state, in float32) — with
    every position at S."""
    from repro_torch.kernels import ops
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as S
    b, s = tokens.shape
    seen: Dict[str, list] = {"x": [], "conv": [], "scan": []}
    orig = (A.gqa_apply, A.mla_apply, S._causal_conv, ops.ssd_scan_mh)

    def spy_attn(fn):
        def call(p, x, cfg_, **kw):
            if kw.get("cache") is None and kw.get("kv_input") is None \
                    and kw.get("tp") is None:
                seen["x"].append(x)
            return fn(p, x, cfg_, **kw)
        return call

    def spy_conv(seq, w):
        seen["conv"].append(seq[:, -(w.shape[0] - 1):].clone())
        return orig[2](seq, w)

    def spy_scan(u, log_decay, b_, c, chunk=128):
        seen["scan"].append((u, log_decay, b_))
        return orig[3](u, log_decay, b_, c, chunk=chunk)
    A.gqa_apply, A.mla_apply = spy_attn(orig[0]), spy_attn(orig[1])
    S._causal_conv, ops.ssd_scan_mh = spy_conv, spy_scan
    try:
        with torch.no_grad():
            lm.forward(params, cfg, tokens, logits_mode="last")
    finally:
        A.gqa_apply, A.mla_apply, S._causal_conv, ops.ssd_scan_mh = orig
    state = lm.init_serve_state(params, cfg, b, max_len)
    caches = state.layer_caches
    pos = torch.arange(s, device=tokens.device, dtype=torch.int32)[None]
    with torch.no_grad():
        for i, lp in enumerate(lm._unstack(params["layers"])):
            if cfg.family in ("ssm", "hybrid"):
                u, ld, bb = seen["scan"][i]
                cum = torch.cumsum(ld, -1)
                w = torch.exp(cum[..., -1:] - cum)
                caches.state[i] = torch.einsum(
                    "bhl,bln,bhlp->bhnp", w, bb.float(), u.float())
                caches.conv[i] = seen["conv"][i]
                continue
            h, p = seen["x"][i], lp["attn"]
            if cfg.mla is not None:
                caches.k[i, :, :s] = h @ p["w_dkv"]
                caches.v[i, :, :s] = L.apply_rope(
                    (h @ p["w_kr"])[:, :, None, :], pos,
                    cfg.rope_theta)[:, :, 0]
            else:
                hd = cfg.resolved_head_dim
                k = (h @ p["wk"]).reshape(b, s, -1, hd)
                caches.k[i, :, :s] = L.apply_rope(k, pos, cfg.rope_theta)
                caches.v[i, :, :s] = (h @ p["wv"]).reshape(b, s, -1, hd)
        if isinstance(caches, lm.A.KVCache):
            caches.pos.fill_(s)
        if cfg.family == "hybrid":
            # each shared-block site's K/V from its captured input
            sites, p = state.shared_cache, params["shared"]["attn"]
            hd = cfg.resolved_head_dim
            for j, h in enumerate(seen["x"]):
                k = (h @ p["wk"]).reshape(b, s, -1, hd)
                sites.k[j, :, :s] = L.apply_rope(k, pos, cfg.rope_theta)
                sites.v[j, :, :s] = (h @ p["wv"]).reshape(b, s, -1, hd)
            sites.pos.fill_(s)
    return state._replace(pos=torch.full_like(state.pos, s))


def lm_mesh_decode(dev, mesh, name, cfg, params, tokens, kernel,
                   floor_ms) -> Dict[str, int]:
    """``decode_step(..., mesh=)`` on the world-size-1 mesh against
    ``decode_step`` without one, :data:`DECODE_STEPS` steps from the same
    prefilled state (:func:`prefilled_state`) on the same tokens: every
    step's logits and the final state bit for bit. At world size 1 every
    block is its whole leaf, so the parameters go in as they are. The mesh
    run's gate calls are captured (the first run) and each distinct one is
    held against its plain version; the second mesh run is counted: the
    gate once per layer a step where ``kernel`` names it, no launch at all
    otherwise. A mesh run with the state donated (``donate=True``, on a
    copy of the prefilled state) must launch the same and give the same
    logits and final state bit for bit, with ``max_memory_allocated``
    beyond the state it starts from lower than the functional mesh run's
    (from a copy it drops after the first step) by 0.9-1.25 cache stacks:
    the functional step holds a new stack beside the old one. Each run's
    ms per step (host clock, synchronised) is reported. Returns the
    counted run's launch counts."""
    b, s = tokens.shape
    state = prefilled_state(params, cfg, tokens, s + DECODE_STEPS)
    blocks = lm.init_serve_state(params, cfg, b, s + DECODE_STEPS, mesh=mesh)
    if [t.shape for t in tree_leaves_state(blocks)] \
            != [t.shape for t in tree_leaves_state(state)]:
        raise AssertionError(f"{name}: init_serve_state(mesh=) blocks "
                             f"differ from the whole state at world size 1")
    del blocks
    steps = torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab_size, (DECODE_STEPS, b, 1))).to(dev)

    def run(mesh_=None, donate=False, fresh=False):
        # fresh: from a copy of the state, held only by the steps
        box = [ckpt._map_with_path(state, lambda _, t: t.clone())
               if fresh else state]
        out = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        with torch.no_grad():
            for t in range(DECODE_STEPS):
                logits, st = lm.decode_step(params, cfg, box.pop(), steps[t],
                                            mesh=mesh_, donate=donate)
                box.append(st)
                out.append(logits)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / DECODE_STEPS
        return out, box.pop(), ms, torch.cuda.max_memory_allocated() - base
    got = []
    cases = capture(lambda: run(mesh), result=got)
    for i, case in enumerate(cases):
        if case["wrapper"] != "moe_gate_topk":
            raise AssertionError(f"{name}: launched {case['wrapper']}")
        check_gate(f"{name}#{i}", case["logits"], case["k"], case["renorm"],
                   path=name, calls=case["calls"], floor_ms=floor_ms)
    reset_launches()
    mesh_logits, mesh_state, mesh_ms, mesh_extra = run(mesh, fresh=True)
    counts = launch_counts()
    reset_launches()
    don_logits, don_state, don_ms, don_extra = run(mesh, donate=True,
                                                   fresh=True)
    don_counts = launch_counts()
    want_logits, want_state, single_ms, _ = run()
    want = {k: 0 for k in counts}
    if kernel is not None:
        want[kernel] = cfg.n_layers * DECODE_STEPS
    if counts != want or don_counts != want:
        raise AssertionError(f"{name}: launches {counts}, donated "
                             f"{don_counts}, expected {want}")

    def same(got_logits, got_state):
        return all(torch.equal(g, w)
                   for g, w in zip(got_logits, want_logits)) and all(
            torch.equal(g, w) for g, w in zip(
                tree_leaves_state(got_state), tree_leaves_state(want_state)))
    if not same(mesh_logits, mesh_state):
        raise AssertionError(f"{name}: the mesh decode differs from the "
                             f"decode without a mesh")
    if not same(don_logits, don_state):
        raise AssertionError(f"{name}: the donated mesh decode differs")
    stack = tensor_bytes((state.layer_caches, state.shared_cache))
    saved = mesh_extra - don_extra
    if not 0.9 <= saved / stack <= 1.25:
        raise AssertionError(f"{name}: the donated decode holds {saved} "
                             f"bytes less than the functional one, against "
                             f"a cache stack of {stack}")
    del mesh_state, don_state, don_logits
    _, _, mesh_ms2, _ = run(mesh)
    _, _, single_ms2, _ = run()
    emit("lm_mesh", run=name, arch=cfg.name, dispatch=cfg.moe.dispatch
         if cfg.moe else None, mesh=list(mesh.shape), batch=b, prefill=s,
         steps=DECODE_STEPS, gate_calls_checked=len(cases),
         launches={k: v for k, v in counts.items() if v},
         bit_exact_vs_single=True, donated_bit_exact=True,
         ms_per_step=statistics.median([mesh_ms, mesh_ms2]),
         single_ms_per_step=statistics.median([single_ms, single_ms2]),
         donated_ms_per_step=don_ms,
         ms_per_step_all=[mesh_ms, mesh_ms2],
         single_ms_per_step_all=[single_ms, single_ms2],
         cache_stack_bytes=stack, max_memory_allocated_over_state=mesh_extra,
         donated_max_memory_allocated_over_state=don_extra,
         donated_saved_bytes=saved, donated_saved_stacks=saved / stack,
         nvidia_smi=smi_line())
    return counts


def tree_leaves_state(state) -> List[torch.Tensor]:
    """A serve state's tensors in field order."""
    out = []
    for part in state:
        if part is None:
            continue
        out.extend(part if isinstance(part, tuple) else [part])
    return out


def phase_lm_mesh(dev, cfg, params, tokens, root, decode, floor_ms
                  ) -> Tuple[Dict[str, Dict[str, int]], Dict[str, str]]:
    """The LM path across GPUs, on the one card: an NCCL process group of
    world size 1 and its ``(1, 1)`` ``("data", "model")`` mesh
    (``specs.lm_mesh``; ``lm_mesh(2, 1)`` must refuse one card), so every
    collective spans one rank and each check is bit-exact. (1) The
    full-width deepseek-v2-lite prefill under ``--opt`` (``catwalk_ep``,
    capacity 1.0) through ``forward(..., mesh=)``: the logits and the aux
    loss equal the forward without a mesh bit for bit, at exactly one gate
    launch per layer; both timed (host clock, median of 3, alternated).
    (2) :func:`lm_mesh_tiles`. (3) :func:`lm_tp_tiles` and
    :func:`tp_bytes_lines`. (4) :func:`lm_mesh_train`. (5)
    :func:`lm_mesh_decode` of deepseek-v2-lite ``--opt`` (these parameters
    and ``tokens``), of internlm2-1.8b (initialised here, at full width)
    and of mamba2-780m (``decode``: its config, parameters and tokens). The
    process group is destroyed at the end. Returns each run's launch
    counts, the kernel each run launches and the SSD kernel's rows at the
    tensor-parallel tile shapes."""
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", init_method=(pathlib.Path(root) / "rendezvous-lm").as_uri(),
        rank=0, world_size=1, timeout=datetime.timedelta(minutes=2))
    try:
        mesh = specs.lm_mesh()
        if tuple(mesh.shape) != (1, 1) or tuple(mesh.mesh_dim_names) != (
                "data", "model") or mesh.device_type != "cuda":
            raise AssertionError(f"lm mesh {tuple(mesh.shape)} "
                                 f"{mesh.mesh_dim_names}")
        try:
            specs.lm_mesh(2, 1)
        except ValueError as e:
            refused = str(e)
        else:
            raise AssertionError("lm_mesh(2, 1) did not refuse one card")
        opt = dryrun.apply_opt(cfg)
        want, want_aux = lm.forward(params, opt, tokens, logits_mode="last")
        mg.reset_launches()
        got, got_aux = lm.forward(params, opt, tokens, logits_mode="last",
                                  mesh=mesh)
        torch.cuda.synchronize()
        gate = mg.LAUNCHES["moe_gate_topk"]
        if not (torch.equal(got, want) and torch.equal(got_aux, want_aux)):
            raise AssertionError("lm_mesh prefill: the mesh forward differs "
                                 "from the forward without one")
        if gate != cfg.n_layers:
            raise AssertionError(f"lm_mesh prefill: {gate} gate launches")
        runs = {"lm_mesh_prefill": launch_counts()}
        times = {"mesh": [], "single": []}
        for _ in range(3):
            for name, kw in (("single", {}), ("mesh", dict(mesh=mesh))):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lm.forward(params, opt, tokens, logits_mode="last", **kw)
                torch.cuda.synchronize()
                times[name].append(1e3 * (time.perf_counter() - t0))
        emit("lm_mesh", run="lm_mesh_prefill", arch=opt.name,
             mesh=list(mesh.shape), dims=list(mesh.mesh_dim_names),
             backend=dist.get_backend(), lm_mesh_2_1_refused=refused,
             dispatch=opt.moe.dispatch,
             capacity_factor=opt.moe.capacity_factor,
             ep_fsdp=opt.moe.ep_fsdp, batch=int(tokens.shape[0]),
             seq=int(tokens.shape[1]), gate_launches=gate,
             bit_exact_vs_single=True,
             forward_ms=statistics.median(times["mesh"]),
             single_forward_ms=statistics.median(times["single"]),
             forward_ms_all=times["mesh"],
             single_forward_ms_all=times["single"])
        del got, want
        with torch.no_grad():
            p, xt = _moe_input(params, opt, tokens)
            lm_mesh_tiles(opt, p, xt)
            lm_plain_tiles(cfg, p, xt, mesh)
            # the plain layer through the mesh: bit for bit at world size 1
            want, want_aux = lm.forward(params, cfg, tokens,
                                        logits_mode="last")
            mg.reset_launches()
            got, got_aux = lm.forward(params, cfg, tokens,
                                      logits_mode="last", mesh=mesh)
            torch.cuda.synchronize()
            runs["lm_mesh_prefill_plain"] = launch_counts()
            if not (torch.equal(got, want) and torch.equal(got_aux, want_aux)
                    ) or mg.LAUNCHES["moe_gate_topk"] != cfg.n_layers:
                raise AssertionError("lm_mesh prefill (plain MoE): the mesh "
                                     "forward differs from the forward "
                                     "without one")
            emit("lm_mesh", run="lm_mesh_prefill_plain", arch=cfg.name,
                 dispatch=cfg.moe.dispatch,
                 gate_launches=mg.LAUNCHES["moe_gate_topk"],
                 bit_exact_vs_single=True)
            del got, want
        del p, xt
        runs["lm_tp_tiles"], tp_rows = lm_tp_tiles(dev, cfg, params, tokens)
        tp_bytes_lines()
        runs.update(lm_mesh_train(dev, mesh))
        runs["lm_mesh_decode_deepseek"] = lm_mesh_decode(
            dev, mesh, "lm_mesh_decode_deepseek", opt, params, tokens,
            "moe_gate_topk", floor_ms)
        dense = lm_registry.get_config(DENSE_ARCH)
        dense_params = lm.init_params(
            torch.Generator(device=dev).manual_seed(0), dense, device=dev)
        runs["lm_mesh_decode_internlm2"] = lm_mesh_decode(
            dev, mesh, "lm_mesh_decode_internlm2", dense, dense_params,
            torch.from_numpy(np.random.default_rng(12).integers(
                0, dense.vocab_size, tuple(tokens.shape))).to(dev),
            None, floor_ms)
        del dense_params
        runs["lm_mesh_decode_mamba2"] = lm_mesh_decode(
            dev, mesh, "lm_mesh_decode_mamba2", *decode, None, floor_ms)
    finally:
        dist.destroy_process_group()
    kernel = {"lm_mesh_prefill": "moe_gate_topk",
              "lm_mesh_prefill_plain": "moe_gate_topk",
              "lm_mesh_train_deepseek": "moe_gate_topk",
              "lm_mesh_train_deepseek_plain": "moe_gate_topk",
              "lm_tp_tiles": "ssd_scan",
              "lm_mesh_decode_deepseek": "moe_gate_topk"}
    return runs, kernel, tp_rows


# ============================================= vlm, audio and hybrid

#: family checks, as fractions of the logits' scale (float32, TF32 off):
#: the card's forward against the CPU's float64 one, and the card's cached
#: decode against its own forward. The hybrid's 7 random SSM layers
#: amplify float32 rounding (a random 48-layer mamba2 reaches 1.1e-3;
#: these 7 layers 1.26e-4 on an H100, with the kernel or with the SSD
#: scan's plain version alike): its gates are the mamba2 checks'
#: per-layer one, LAYER_TOL_F32, with the kernel and with the plain
#: version on the card (reported beside it)
FAMILY_TOL = {"vlm": 1e-4, "audio": 1e-4, "hybrid": LAYER_TOL_F32}


def phase_family_checks(dev, cfg, params) -> None:
    """Cross-checks of a vlm, audio or hybrid model at full width in
    float32 (copies of the bf16 weights, upcast; TF32 off), depth cut: 2
    layers (audio: 2 encoder and 2 decoder layers; hybrid: 7 layers with
    the config's period 6, so one shared-block site and a tail layer run).
    (1) The card's forward (vlm: after 64 patch embeddings; audio: over 128
    frames) against the CPU's plain forward in float64, within FAMILY_TOL
    of the logits' scale (hybrid: with the kernel and with the SSD scan's
    plain version on the card). (2) The card's cached decode token by token (audio:
    cross-attending to the encoder output held in the state; hybrid: the
    shared block over its site's cache) against the card's own forward
    (vlm: text only, as decode takes no patches), within FAMILY_TOL."""
    family = cfg.family
    rng = np.random.default_rng(13)
    if family == "hybrid":
        cut = dataclasses.replace(cfg, dtype="float32", n_layers=7)
        seq = 256
    elif family == "audio":
        cut = dataclasses.replace(cfg, dtype="float32", n_layers=2,
                                  encdec=dataclasses.replace(
                                      cfg.encdec, n_encoder_layers=2))
        seq = 32
    else:
        cut = dataclasses.replace(cfg, dtype="float32", n_layers=2)
        seq = 64
    p32 = _cut_f32(params, cut.n_layers, 2 if family == "audio" else 0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (1, seq))).to(dev)
    extra = {}
    if family == "vlm":
        extra["patches"] = frontend(cfg, 1, 64, 14)
    elif family == "audio":
        extra["frames"] = frontend(cfg, 1, 128, 15)
    ss.reset_launches()
    card, _ = lm.forward(p32, cut, toks, **extra)
    launches = ss.LAUNCHES["ssd_scan"]
    host, _ = lm.forward(_map(p32, lambda t: t.cpu().double()), cut,
                         toks.cpu(), **{k: v.astype(np.float64)
                                        for k, v in extra.items()})
    card_cpu = _over_scale(card.cpu(), host)
    plain_cpu = card_cpu
    if family == "hybrid":
        kernel = ss._ssd_scan
        ss._ssd_scan = ss._ssd_scan_plain
        try:
            plain, _ = lm.forward(p32, cut, toks)
        finally:
            ss._ssd_scan = kernel
        plain_cpu = _over_scale(plain.cpu(), host)
        del plain
    want_launches = cut.n_layers if family == "hybrid" else 0
    tol = FAMILY_TOL[family]
    if host.dtype != torch.float64 or not max(card_cpu, plain_cpu) <= tol \
            or launches != want_launches:
        raise AssertionError(f"{cfg.name}: card vs CPU float64 forward "
                             f"{card_cpu} (the plain SSD scan on the card: "
                             f"{plain_cpu}), {launches} SSD launches")
    del host
    fwd = card if family != "vlm" else lm.forward(p32, cut, toks)[0]
    frames = extra.get("frames")
    state = lm.init_serve_state(p32, cut, 1, seq, frames=frames)
    dec = []
    for t in range(seq):
        logits, state = lm.decode_step(p32, cut, state, toks[:, t:t + 1])
        dec.append(logits)
    fwd_dec = _over_scale(torch.stack(dec, dim=1), fwd)
    if not fwd_dec <= tol:
        raise AssertionError(f"{cfg.name}: forward vs decode {fwd_dec}")
    emit("family_checks", arch=cfg.name, family=family,
         tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         layers=cut.n_layers, seq=seq,
         **{k: int(v.shape[1]) for k, v in extra.items()},
         card_vs_cpu=dict(card_dtype="float32", host_dtype="float64",
                          logits_mode="all", max_err_over_scale=card_cpu,
                          tol=tol, ssd_launches=launches,
                          plain_scan_max_err_over_scale=plain_cpu),
         forward_vs_decode=dict(max_err_over_scale=fwd_dec, tol=tol,
                                shared_sites=len(state.shared_cache.k)
                                if state.shared_cache is not None else 0,
                                encoder_frames=int(state.enc_out.shape[1])
                                if state.enc_out is not None else 0))


def phase_family(dev, arch, root) -> Tuple[Dict[str, Dict[str, int]],
                                           Dict[str, Optional[str]]]:
    """One of the last three LM families at full width and depth, alone on
    the card: random bf16 weights from a seeded generator, its two paths
    (a capture pass that also warms them: every SSD call the prefill makes
    held against the plain version, the first timed: row 5 at zamba2's
    call; an engine path that must launch no kernel is not captured, as
    for the earlier paths), the measured run of each path with its launch
    counts, the
    prefill's host-clock time, a profile of the prefill and of a decode
    step, and :func:`phase_family_checks`. The hybrid also decodes
    through ``decode_step(..., mesh=)`` on an NCCL world-size-1 mesh
    (:func:`lm_mesh_decode`: its site caches gathered one site at a time,
    bit for bit with the decode without a mesh). Returns each path's
    launch counts and kernel."""
    cfg = lm_registry.get_config(arch)
    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                            device=dev)
    extra: Dict[str, Any] = {}
    per_slot = False
    if cfg.family == "vlm":
        tokens = torch.from_numpy(np.random.default_rng(16).integers(
            0, cfg.vocab_size, (VLM_B, VLM_S))).to(dev)
        extra["patches"] = torch.from_numpy(frontend(
            cfg, VLM_B, cfg.frontend.n_tokens, 17)).to(dev)
        prompts = requests(cfg.vocab_size, VLM_REQUESTS, VLM_MAX_PROMPT, 1)
        paths = vlm_paths(dev, cfg, params, tokens, extra["patches"],
                          prompts)
        decode_prompts, per_slot = prompts[:VLM_SLOTS], True
    elif cfg.family == "audio":
        tokens = torch.from_numpy(np.random.default_rng(18).integers(
            0, cfg.vocab_size, (AUDIO_B, AUDIO_S))).to(dev)
        extra["frames"] = torch.from_numpy(frontend(
            cfg, AUDIO_B, cfg.encdec.encoder_seq, 19)).to(dev)
        prompts = requests(cfg.vocab_size, AUDIO_B, AUDIO_MAX_PROMPT, 2)
        paths = audio_paths(dev, cfg, params, tokens, extra["frames"],
                            prompts)
        decode_prompts = prompts
    else:
        tokens = torch.from_numpy(np.random.default_rng(20).integers(
            0, cfg.vocab_size, (HYBRID_B, HYBRID_L))).to(dev)
        prompts = lm_prompts()[:HYBRID_B]
        paths = hybrid_paths(dev, cfg, params, tokens, prompts)
        decode_prompts = prompts
    # the prefill (paths[0]) is captured, and so warmed, even without a
    # kernel; an engine path without one (host-bound, seconds a run) is not
    captured = {path.name: capture(path.run)
                if path.kernel or path is paths[0] else [] for path in paths}
    for name, cases in captured.items():
        for i, case in enumerate(cases):
            for k, ops in enumerate(case.get("operands", [])):
                check_ssd(f"{name}#{i}/call{k}", *ops, case["chunk"],
                          case["heads"], timed=k == 0, path=name,
                          calls=case["calls"])
    launches = phase_serve(paths, captured)
    del captured
    phase_lm_prefill(cfg, params, tokens, f"{cfg.family}_prefill_time",
                     **extra)
    phase_profile_path(paths[0])
    phase_profile_decode(cfg, params, decode_prompts,
                         f"{cfg.family}_decode_step", per_slot=per_slot,
                         frames=None if "frames" not in extra
                         else extra["frames"][:len(decode_prompts)])
    phase_family_checks(dev, cfg, params)
    kernels = {path.name: path.kernel for path in paths}
    if cfg.family == "hybrid":
        import torch.distributed as dist
        dist.init_process_group(
            "nccl", init_method=(pathlib.Path(root)
                                 / "rendezvous-hybrid").as_uri(),
            rank=0, world_size=1, timeout=datetime.timedelta(minutes=2))
        try:
            launches["lm_mesh_decode_zamba2"] = lm_mesh_decode(
                dev, specs.lm_mesh(), "lm_mesh_decode_zamba2", cfg, params,
                tokens, None, None)
        finally:
            dist.destroy_process_group()
        kernels["lm_mesh_decode_zamba2"] = None
    return launches, kernels


# ================================================= fused GQA attention

#: the fused kernel's calls on the benchmark's paths (internlm2-1.8b: 16
#: heads in 8 KV groups of 128, causal): (name, B, S)
GQA_CALLS = (("prefill", 1, 32768), ("train", 2, 4096))
GQA_HEADS, GQA_GROUPS, GQA_DIM = 16, 8, 128


#: the last queries whose float32 outputs are held against float64
GQA_CHECK_ROWS = 256


def _tail_f64(q, k, v, scale, n):
    """Float64 attention of the last ``n`` causal queries over every key
    (they see all of them): (B, n, H, D)."""
    b, s, h, d = q.shape
    g = k.shape[2]
    qf = q[:, s - n:].double().reshape(b, n, g, h // g, d)
    sc = torch.einsum("bigrd,bjgd->bgrij", qf, k.double()) * scale
    allowed = (torch.arange(s - n, s, device=q.device)[:, None]
               >= torch.arange(s, device=q.device)[None, :])
    sc = torch.where(allowed, sc, float("-inf"))
    z = torch.exp(sc - sc.amax(-1, keepdim=True))
    out = torch.einsum("bgrij,bjgd->bigrd", z / z.sum(-1, keepdim=True),
                       v.double())
    return out.reshape(b, n, h, d)


def _f32_plain(A, q, k, v):
    """The plain path's float32 output (its f32 result before the cast)."""
    with torch.no_grad():
        return A._sdpa_plain(q.float(), k.float(), v.float(), True, None)


def gqa_bound_ms(b: int, s: int) -> float:
    """The causal call's model FLOPs (Q K^T and P V at or below the
    diagonal) at the card's bf16 dense rate."""
    return 4 * b * GQA_HEADS * GQA_DIM * s * s / 2 / roofline.PEAK_FLOPS * 1e3


def gqa_main_path_launches(dev) -> Dict[str, int]:
    """The fused kernel's launches on the main path at the benchmark's
    calls (:data:`GQA_CALLS`), each counted from 0 just before its run:
    internlm2-1.8b's prefill forward on 1 x 32,768 tokens
    (``logits_mode="last"``: one a layer) and one training microbatch of
    2 x 4,096 (``train_loop.grads_of``: one a layer in the forward and one
    in the block remat's recompute). Raises on any other count or any
    other kernel."""
    cfg = lm_registry.get_config(DENSE_ARCH)
    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                            device=dev)
    rng = np.random.default_rng(32)
    (_, pb, ps), (_, tb, ts) = GQA_CALLS
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (pb, ps))
                              ).to(dev)
    ids = rng.integers(0, cfg.vocab_size, (tb, ts + 1))
    batch = {"tokens": ids[:, :-1], "labels": ids[:, 1:]}
    runs = {"prefill": (lambda: lm.forward(params, cfg, tokens,
                                            logits_mode="last"),
                        gqa_calls(cfg)),
            "train": (lambda: TL.grads_of(params, cfg, batch),
                      gqa_train_calls(cfg, 1))}
    out = {}
    for name, (run, want) in runs.items():
        torch.cuda.synchronize()
        reset_launches()
        if name == "prefill":
            with torch.no_grad():
                run()
        else:
            run()
        torch.cuda.synchronize()
        counts = {k: v for k, v in launch_counts().items() if v}
        if counts != {ATTENTION_KERNEL: want}:
            raise AssertionError(f"gqa_attention: the {name} run launched "
                                 f"{counts}, expected {want} of "
                                 f"{ATTENTION_KERNEL}")
        out[name] = want
    del params, tokens
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_gqa_attention(dev, smi) -> None:
    """The fused GQA attention kernel (``kernels/gqa_attention.py``) at the
    benchmark's two calls: its device time (profiler) beside the bound,
    the plain path's time (``attention._sdpa_plain``, no gradient), the
    library's (``torch.nn.functional.scaled_dot_product_attention``, a
    yardstick the port never calls), one kernel a call, the memory a call
    adds, and its output against the plain path's (at most one bf16 step
    apart, a step of at least 2^-8 of the row's largest value, or
    raise). ``launches``: the kernel's launches on the main path at that
    call (:func:`gqa_main_path_launches`)."""
    from repro_torch.models import attention as A
    lib = build.build("gqa_attention")
    main = gqa_main_path_launches(dev)
    gen = torch.Generator(device=dev).manual_seed(31)
    for name, b, s in GQA_CALLS:
        q, k, v = (torch.randn((b, s, h, GQA_DIM), generator=gen,
                               device=dev).bfloat16()
                   for h in (GQA_HEADS, GQA_GROUPS, GQA_GROUPS))
        scale = A._inv_sqrt(GQA_DIM)

        def kernel():
            return ga.gqa_attention(q, k, v, True, scale)

        def plain():
            with torch.no_grad():
                return A._sdpa_plain(q, k, v, True, None)

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, scale=scale, enable_gqa=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        got = kernel()
        torch.cuda.synchronize()
        added = torch.cuda.max_memory_allocated() - base
        ms, per_call = kernel_ms(kernel, reps=20, key="gqa_attention")
        want = plain()
        # bf16 steps of the larger magnitude, taken at least 2^-8 of the
        # row's largest (below it the two f32 sums' own rounding, ~1e-5
        # of the row's scale, exceeds a bf16 step)
        a, w = got.double().abs(), want.double().abs()
        big = torch.maximum(a, w)
        big = torch.maximum(big, big.amax(-1, keepdim=True) * 2.0 ** -8)
        steps = float(((got.double() - want.double()).abs() / torch.exp2(
            torch.floor(torch.log2(big.clamp_min(2.0 ** -126))) - 7)).max())
        del want, a, w, big, got
        # float32 outputs of the last GQA_CHECK_ROWS queries (every key)
        # against float64: each row's error norm over its norm
        tail = slice(s - GQA_CHECK_ROWS, s)
        f64 = _tail_f64(q, k, v, scale, GQA_CHECK_ROWS)
        errs = {}
        for label, out in (
                ("kernel", ga.gqa_attention(q, k, v, True, scale,
                                            torch.float32)[:, tail]),
                ("plain", _f32_plain(A, q, k, v)[:, tail])):
            errs[label] = float(((out.double() - f64).norm(dim=-1)
                                 / f64.norm(dim=-1)).max())
        del f64, out
        plain_ms = time_ms(plain, reps=3, warmup=1)
        library_ms = time_ms(library, reps=20, warmup=2)
        bound = gqa_bound_ms(b, s)
        emit("gqa_attention", call=name, shape=[b, s, GQA_HEADS, GQA_DIM],
             groups=GQA_GROUPS, causal=True, device_ms=ms,
             kernels_per_call=per_call, bound_ms=bound,
             share_of_peak=None if ms is None else bound / ms,
             plain_ms=plain_ms, library_ms=library_ms,
             launches=main[name], max_bf16_steps=steps,
             f32_row_err_vs_f64=errs["kernel"],
             plain_f32_row_err_vs_f64=errs["plain"],
             added_bytes=added, build=str(lib.parent.name),
             ptxas=ptxas_report("gqa_attention"), nvidia_smi=smi)
        if steps > 1.0 or per_call != 1 or errs["kernel"] > 2e-5:
            raise AssertionError(f"gqa_attention at the {name} call: "
                                 f"{steps} bf16 steps from the plain path, "
                                 f"f32 row error {errs['kernel']}, "
                                 f"{per_call} kernels a call")
        del q, k, v
        gc.collect()
        torch.cuda.empty_cache()


# ====================================================== blocked attention

#: llama3.2-3b at full width, bf16, random weights: 24 heads, which do
#: not split over a model axis of 16, so one (16, 16) rank of
#: ``prefill_32k`` scores every head of its 2 rows of 32,768 tokens; depth
#: cut to ATTN_LAYERS of 28 (the plain path's f32 score passes take ~1 s
#: a layer)
ATTN_ARCH = "llama3.2-3b"
ATTN_B, ATTN_S, ATTN_LAYERS = 2, 32768, 8
#: the card's peak against the dry run's count of the same step
#: (``max_memory_allocated`` over the predicted live bytes)
ATTN_PEAK_TOL = 0.01
#: blocked against whole attention: float32 (TF32 off) on 2 x 4,096
#: tokens, blocks of ATTN_CHECK_BLOCK queries against one block, logits
#: within the float32 forwards' tolerance of their scale
ATTN_CHECK_S, ATTN_CHECK_BLOCK, ATTN_CHECK_TOL = 4096, 512, 1e-4


def phase_attention(dev, smi) -> None:
    """Attention at a length whose whole scores would need ~200 GB a layer:
    llama3.2-3b's forward (:data:`ATTN_LAYERS` layers,
    ``logits_mode="last"``, no gradient) on :data:`ATTN_B` x
    :data:`ATTN_S` tokens, one device. (1) Through the fused kernel, the
    path the port takes: one launch a layer, and the card's
    ``max_memory_allocated`` against the dry run's count of the same step
    on fake CPU tensors (:func:`repro_torch.launch.dryrun.measure`, which
    models the kernel: its output alone), within :data:`ATTN_PEAK_TOL`.
    (2) The plain path scored in blocks of queries
    (``attention._by_query_blocks``; ``attention._sdpa`` set to
    ``_sdpa_plain`` for this run alone, TF32 on: the f32 score products'
    precision moves no byte): it must launch no kernel and peak above the
    kernel's path. (3) The plain path's float32 forward on 2 x
    :data:`ATTN_CHECK_S` tokens with blocks of :data:`ATTN_CHECK_BLOCK`
    queries against one block of every query: every logit within
    :data:`ATTN_CHECK_TOL` of their scale."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models import attention as A
    cfg = dataclasses.replace(lm_registry.get_config(ATTN_ARCH),
                              n_layers=ATTN_LAYERS)
    host = torch.from_numpy(np.random.default_rng(21).integers(
        0, cfg.vocab_size, (ATTN_B, ATTN_S)))

    def step(params, tokens):
        with torch.no_grad():
            return lm.forward(params, cfg, tokens, logits_mode="last")[0]
    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = lm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
        pred = dryrun.measure(step, (fake, host), tensor_bytes(fake) +
                              tensor_bytes(host), tensor_bytes(fake))
        del fake
    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                            device=dev)
    tokens = host.to(dev)

    def measured(run):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        return (out, 1e3 * (time.perf_counter() - t0),
                torch.cuda.max_memory_allocated(), launch_counts())
    base = torch.cuda.memory_allocated()
    logits, ms, peak, counts = measured(lambda: step(params, tokens))
    finite = bool(torch.isfinite(logits).all())
    rel = peak / pred["peak_bytes"] - 1
    tf32 = torch.backends.cuda.matmul.allow_tf32
    sdpa = A._sdpa
    torch.backends.cuda.matmul.allow_tf32 = True
    A._sdpa = lambda q, k, v, *, causal, kv_valid=None: A._sdpa_plain(
        q, k, v, causal, kv_valid)
    try:
        plain, plain_ms, plain_peak, plain_counts = measured(
            lambda: step(params, tokens))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        A._sdpa = sdpa
    plain_err = float((plain.float() - logits.float()).abs().max()
                      / plain.float().abs().max())
    del plain
    emit("attention", run="llama_prefill_rank", arch=cfg.name,
         batch=ATTN_B, seq=ATTN_S, heads=cfg.n_heads, dtype=cfg.dtype,
         whole_scores_bytes_per_layer=4 * ATTN_B * cfg.n_heads * ATTN_S ** 2,
         predicted_peak_bytes=pred["peak_bytes"],
         max_memory_allocated=peak, memory_allocated_before=base,
         peak_over_predicted=peak / pred["peak_bytes"], tol=ATTN_PEAK_TOL,
         forward_ms=ms, launches={k: v for k, v in counts.items() if v},
         finite=finite, trace_s=pred["trace_s"], nvidia_smi=smi)
    emit("attention", run="llama_prefill_plain", arch=cfg.name,
         batch=ATTN_B, seq=ATTN_S, score_block_bytes=A.SCORE_BLOCK_BYTES,
         queries_per_block=A.SCORE_BLOCK_BYTES // (
             4 * ATTN_B * cfg.n_heads * ATTN_S),
         max_memory_allocated=plain_peak, forward_ms=plain_ms, tf32=True,
         launches={k: v for k, v in plain_counts.items() if v},
         logits_err_over_scale_vs_kernel=plain_err, nvidia_smi=smi)
    want = {**{k: 0 for k in counts}, ATTENTION_KERNEL: gqa_calls(cfg)}
    if counts != want or any(plain_counts.values()):
        raise AssertionError(f"attention: launches {counts} through the "
                             f"kernel (expected {want}), {plain_counts} on "
                             f"the plain path")
    if not finite or abs(rel) > ATTN_PEAK_TOL:
        raise AssertionError(f"attention: llama {ATTN_B} x {ATTN_S}: peak "
                             f"{peak} against the dry run's "
                             f"{pred['peak_bytes']}, finite {finite}")
    if peak >= plain_peak:
        raise AssertionError(f"attention: the kernel's forward peaks at "
                             f"{peak}, not below the plain path's "
                             f"{plain_peak}")
    del logits
    f32 = tree_unflatten(params, [t.float() for t in tree_leaves(params)])
    del params
    f32cfg = dataclasses.replace(cfg, dtype="float32")
    short = tokens[:, :ATTN_CHECK_S]
    row = 4 * ATTN_B * cfg.n_heads * ATTN_CHECK_S
    out = {}
    budget = A.SCORE_BLOCK_BYTES
    try:
        for name, blocks in (("whole", 1 << 62),
                             ("blocked", ATTN_CHECK_BLOCK * row)):
            A.SCORE_BLOCK_BYTES = blocks
            with torch.no_grad():
                out[name] = lm.forward(f32, f32cfg, short)[0]
    finally:
        A.SCORE_BLOCK_BYTES = budget
    scale = float(out["whole"].abs().max())
    err = float((out["blocked"] - out["whole"]).abs().max()) / scale
    emit("attention", run="blocked_vs_whole", arch=cfg.name, dtype="float32",
         batch=ATTN_B, seq=ATTN_CHECK_S, queries_per_block=ATTN_CHECK_BLOCK,
         blocks=ATTN_CHECK_S // ATTN_CHECK_BLOCK, max_err_over_scale=err,
         tol=ATTN_CHECK_TOL, nvidia_smi=smi)
    if not err <= ATTN_CHECK_TOL:
        raise AssertionError(f"attention: blocked logits differ from the "
                             f"whole form's by {err} of scale")
    del f32, out
    gc.collect()
    torch.cuda.empty_cache()


# ================================================================ training

#: LM training through the launcher (``repro_torch.launch.train``) at full
#: width and depth, random weights: the train_4k length (configs/base.py
#: SHAPES), a global batch of 8 in 4 microbatches of 2, bf16, remat on
#: (the configs' own), 3 steps; mamba2-780m with top-k gradient
#: compression at the launcher's rho (0.01). internlm2-1.8b is the dense
#: decoder the reference's own training tests train (tests/test_runtime.py).
TRAIN_DENSE, TRAIN_SSM, TRAIN_MOE = ("internlm2-1.8b", "mamba2-780m",
                                     "deepseek-v2-lite-16b")
#: zamba2-1.2b trains the same way (the SSD kernel in each of its 38
#: layers' forward and recompute, the shared block's 32 heads of f32
#: scores at each of its 6 sites)
TRAIN_HYBRID = HYBRID_ARCH
TRAIN_SEQ, TRAIN_BATCH, TRAIN_ACCUM, TRAIN_STEPS = 4096, 8, 4, 3
#: deepseek-v2-lite-16b's 16 B parameters with f32 moments do not fit one
#: card: the MoE gate trains at the smoke size (the launcher's --smoke
#: batch and length), in 2 microbatches
MOE_TRAIN_ACCUM = 2
#: copies of a training path's SSD operands held against the plain version
TRAIN_SSD_COPIES = 2
#: the launcher's learning rate, and the smoke checks': float32 card
#: against CPU (loss and grad norm, relative) and the updated leaves
#: (within 1e-5 (1 + |p|) except near-zero-gradient elements, which
#: AdamW's first step turns into +-lr: at most 0.2 % of a leaf, within
#: 1e-4 of its largest gradient, moved by at most 2 lr)
TRAIN_LR, CHECK_LR = 3e-4, 1e-2
TRAIN_CARD_CPU_TOL, TRAIN_LEAF_TOL = 1e-4, 1e-5


def launcher_argv(arch: str, ckpt_dir, *, smoke=False, steps=TRAIN_STEPS,
                  seq=None, batch=None, accum=TRAIN_ACCUM,
                  compress=False, every=1_000_000) -> List[str]:
    return ["--arch", arch, *(["--smoke"] if smoke else []),
            "--steps", str(steps), "--grad-accum", str(accum),
            *(["--seq-len", str(seq)] if seq else []),
            *(["--global-batch", str(batch)] if batch else []),
            *(["--compress"] if compress else []),
            "--lr", str(TRAIN_LR), "--ckpt-dir", str(ckpt_dir),
            "--ckpt-every", str(every), "--device", "cuda"]


def launcher_step_fn(argv: List[str]):
    """The train step the launcher builds for ``argv`` (its config and
    train config; the state donated), and its data."""
    cfg, tcfg, data = train_launcher.setup(
        train_launcher.parser().parse_args(argv))
    return cfg, TL.make_train_step(cfg, tcfg, donate=True), data


def train_paths(root, smi) -> List[Tuple[Path, List[str]]]:
    """The training paths, each one launcher run (``launch.train.main``):
    internlm2-1.8b (the fused attention kernel in each layer's forward and
    again in its recompute: 2 x 24 launches a microbatch), mamba2-780m
    with compression (the SSD scan
    in each layer's forward and again in its recompute: 2 x 48 launches a
    microbatch) and deepseek-v2-lite-16b at the smoke size (the MoE gate,
    2 x 2 launches a microbatch). Each run returns its losses, step times
    and final state; the check holds the losses and parameters finite and
    reports ms per step (the median of the steps after the first), tokens
    per second and the peak of ``torch.cuda.max_memory_allocated``.
    Returns each path with its launcher arguments."""
    def path(name, arch, kernel, **kw):
        argv = launcher_argv(arch, pathlib.Path(root) / name, **kw)
        args = train_launcher.parser().parse_args(argv)
        cfg, _, data = train_launcher.setup(args)
        seq, batch = data.cfg.seq_len, data.cfg.global_batch
        accum = args.grad_accum

        def run():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            out = train_launcher.main(argv)
            torch.cuda.synchronize()
            return out, dict(max_memory_allocated=
                             torch.cuda.max_memory_allocated())

        def check(out, st):
            state, losses = out["state"], out["losses"]
            finite = all(bool(torch.isfinite(t).all())
                         for t in tree_leaves(state.params))
            if len(losses) != TRAIN_STEPS or int(state.step) != TRAIN_STEPS \
                    or not all(map(math.isfinite, losses)) or not finite:
                raise AssertionError(f"{name}: losses {losses}, step "
                                     f"{int(state.step)}, finite params "
                                     f"{finite}")
            ms = 1e3 * statistics.median(out["step_s"][1:])
            return dict(arch=cfg.name, layers=cfg.n_layers, dtype=cfg.dtype,
                        remat=cfg.remat, seq=seq, global_batch=batch,
                        grad_accum=accum, microbatch=batch // accum,
                        compress=args.compress, lr=args.lr,
                        steps=TRAIN_STEPS, losses=losses,
                        step_ms_all=[1e3 * t for t in out["step_s"]],
                        ms_per_step=ms,
                        tokens_per_s=batch * seq / (ms / 1e3),
                        max_memory_allocated_gb=st["max_memory_allocated"]
                        / 2 ** 30, params=cfg.param_count(),
                        nvidia_smi=smi)

        # one launch a layer, and one more in its recompute under remat
        per_layer = 2 if cfg.remat == "block" else 1
        launches = None if kernel is None \
            else per_layer * cfg.n_layers * accum * TRAIN_STEPS
        return Path(name, kernel, run, check, launches=launches,
                    attention=gqa_train_calls(cfg, accum * TRAIN_STEPS)), \
            argv

    return [
        path("train_internlm2", TRAIN_DENSE, None, seq=TRAIN_SEQ,
             batch=TRAIN_BATCH),
        path("train_mamba2", TRAIN_SSM, "ssd_scan", seq=TRAIN_SEQ,
             batch=TRAIN_BATCH, compress=True),
        path("train_zamba2", TRAIN_HYBRID, "ssd_scan", seq=TRAIN_SEQ,
             batch=TRAIN_BATCH),
        path("train_moe_smoke", TRAIN_MOE, "moe_gate_topk", smoke=True,
             accum=MOE_TRAIN_ACCUM)]


def phase_train(paths_argv, smi, root
                ) -> Tuple[Dict[str, Dict[str, int]], Dict[str, list],
                           Dict[str, Optional[str]]]:
    """The training paths, each run once with the launch counts set to 0
    just before it and read just after, its kernel calls captured on the
    way (the first TRAIN_SSD_COPIES SSD operand copies of a path); each
    must launch its kernel as often as its config says and no other. A
    step of each full-width path is then profiled from the state the run
    ended in: device busy time, idle share and top device ops. The paths
    of :data:`LM_MESH_FULL` then run again through the mesh step
    (:func:`lm_mesh_train_full`), their kernel calls captured as well.
    Returns each run's launch counts, its captured calls and the kernel
    of each mesh run."""
    launches, captured, mesh_kernels = {}, {}, {}
    for path, argv in paths_argv:
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        got: list = []
        cases = capture(path.run, TRAIN_SSD_COPIES, got)
        torch.cuda.synchronize()
        run_ms = 1e3 * (time.perf_counter() - t0)
        counts = launch_counts()
        out, st = got[0]
        fields = path.check(out, st)
        per_step = {k: v / TRAIN_STEPS for k, v in counts.items() if v}
        emit("train", run=path.name, **fields, run_ms=run_ms,
             launches=counts, launches_per_step=per_step)
        check_launches(path, counts, cases, st)
        launches[path.name], captured[path.name] = counts, cases
        ref = None
        if path.name in LM_MESH_FULL:
            # the single run's losses and state on the host (before the
            # profiled step writes over the state): its state and the mesh
            # run's are never on the card together
            ref = dict(losses=out["losses"], step_s=out["step_s"],
                       max_memory_allocated=st["max_memory_allocated"],
                       state=host_leaves(out["state"]))
        if path.name != "train_moe_smoke":
            phase_profile_train(path.name, argv, out["state"], smi)
        del out, got
        gc.collect()
        torch.cuda.empty_cache()
        if ref is not None:
            name = f"lm_mesh_{path.name}"
            runs: list = []
            cases = capture(lambda: lm_mesh_train_full(
                path, argv, ref, root), TRAIN_SSD_COPIES, runs)
            launches[name], captured[name] = runs[0], cases
            mesh_kernels[name] = path.kernel
            del ref, runs
            gc.collect()
            torch.cuda.empty_cache()
    return launches, captured, mesh_kernels


#: the full-width training paths the mesh step repeats, each with
#: ``--opt`` or not (mamba2: ``batch_over_model``, a layout alone on one
#: device, so the single run without it is the same function)
LM_MESH_FULL = {"train_internlm2": False, "train_mamba2": True}


def host_leaves(state) -> Dict[str, torch.Tensor]:
    """Every tensor leaf of a train state by checkpoint key, copied to the
    host one leaf at a time."""
    out: Dict[str, torch.Tensor] = {}

    def put(key, leaf):
        if isinstance(leaf, torch.Tensor):
            out[key] = leaf.cpu()
        return leaf
    ckpt._map_with_path(state, put)
    return out


def lm_mesh_train_full(path, argv, ref, root) -> Dict[str, int]:
    """The mesh train step at full width on an NCCL world-size-1 ``(1,
    1)`` mesh: the launcher's config, train config and data for ``argv``
    (``--opt`` where :data:`LM_MESH_FULL` says), the state made as blocks
    by ``init_train_state(mesh=)`` from the launcher's seed, and
    TRAIN_STEPS steps of ``make_train_step(mesh=, donate=True)`` (the
    launcher's mesh step) on the launcher's
    batches. Every loss and every leaf of the gathered final state must
    equal the single-device launcher run's (``ref``, on the host) bit for
    bit, and the path's kernel must launch as often as in that run and no
    other. Returns the launch counts; the process group is destroyed at
    the end."""
    import torch.distributed as dist
    opt = LM_MESH_FULL[path.name]
    args = train_launcher.parser().parse_args(
        argv + (["--opt"] if opt else []))
    cfg, tcfg, data = train_launcher.setup(args)
    dev = torch.device("cuda")
    name = f"lm_mesh_{path.name}"
    dist.init_process_group(
        "nccl", init_method=(pathlib.Path(root) / f"rendezvous-{name}"
                             ).as_uri(),
        rank=0, world_size=1, timeout=datetime.timedelta(minutes=5))
    try:
        mesh = specs.lm_mesh()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        state = TL.init_train_state(torch.Generator(device=dev).manual_seed(
            0), cfg, tcfg, device=dev, mesh=mesh)
        # the launcher's mesh step: its state donated
        step = TL.make_train_step(cfg, tcfg, mesh=mesh, donate=True)
        losses, step_s = [], []
        for i in range(TRAIN_STEPS):
            ts = time.perf_counter()
            state, metrics = step(state, data.batch(i))
            losses.append(float(metrics["loss"]))
            step_s.append(time.perf_counter() - ts)
        torch.cuda.synchronize()
        run_ms = 1e3 * (time.perf_counter() - t0)
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        whole = specs.gather_tree(state, TL.state_pspecs(cfg, tcfg, mesh),
                                  mesh)
        del state
        got = host_leaves(whole)
        del whole
    finally:
        dist.destroy_process_group()
    want = ref["state"]
    differ = sorted(k for k in want if k not in got or not torch.equal(
        got[k], want[k]))
    if losses != ref["losses"] or got.keys() != want.keys() or differ:
        raise AssertionError(f"{name}: the mesh step differs from the "
                             f"single-device run (losses {losses} vs "
                             f"{ref['losses']}; leaves {differ[:5]})")
    for kernel, n in counts.items():
        expect = path.attention if kernel == ATTENTION_KERNEL \
            else path.launches if kernel == path.kernel else 0
        if n != expect:
            raise AssertionError(f"{name}: {n} launches of {kernel}, "
                                 f"expected {expect}")
    ms = 1e3 * statistics.median(step_s[1:])
    single_ms = 1e3 * statistics.median(ref["step_s"][1:])
    seq, batch = data.cfg.seq_len, data.cfg.global_batch
    emit("lm_mesh", run=name, arch=cfg.name, opt=opt, dtype=cfg.dtype,
         mesh=list(mesh.shape), batch_over_model=cfg.batch_over_model,
         layers=cfg.n_layers, seq=seq, global_batch=batch,
         grad_accum=tcfg.grad_accum, compress=tcfg.compressing,
         steps=TRAIN_STEPS, losses=losses, bit_exact_vs_single=True,
         leaves=len(got), ms_per_step=ms, single_ms_per_step=single_ms,
         step_ms_all=[1e3 * t for t in step_s],
         single_step_ms_all=[1e3 * t for t in ref["step_s"]],
         tokens_per_s=batch * seq / (ms / 1e3), run_ms=run_ms,
         max_memory_allocated_gb=peak / 2 ** 30,
         single_max_memory_allocated_gb=ref["max_memory_allocated"] / 2 ** 30,
         launches={k: v for k, v in counts.items() if v},
         nvidia_smi=smi_line())
    return counts


def phase_profile_train(name, argv, state, smi) -> None:
    """One more launcher step (its 4 microbatches, compression and AdamW;
    ``state`` donated to it) from ``state`` under the profiler (device activity only), ended by a
    synchronise: device busy time, idle share (an upper estimate: the
    profiler's host cost), device ops and the top ones; the SSD launches
    in it."""
    cfg, step_fn, data = launcher_step_fn(argv)
    batch = data.batch(TRAIN_STEPS)
    torch.cuda.synchronize()
    reset_launches()
    # device activity only: a step makes 30k-150k device ops, and host op
    # records would add to the wall time and to the profile's reading
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        new, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    del new
    emit("profile", run=name, steps=1, loss=loss,
         launches=launch_counts(), nvidia_smi=smi,
         **device_share(device_events(prof), wall_ms))


def _check_update(want, got, grads, lr, label) -> int:
    """Updated leaves ``got`` against ``want`` (module constants); returns
    the elements moved by a near-zero gradient."""
    moved = 0
    for w, g_, grad in zip(tree_leaves(want), tree_leaves(got),
                           tree_leaves(grads)):
        w, g_, grad = w.double(), g_.double().to(w.device), \
            grad.double().abs().to(w.device)
        diff = (g_ - w).abs()
        off = diff > TRAIN_LEAF_TOL * (1 + w.abs())
        n = int(off.sum())
        if n and (n > 0.002 * off.numel()
                  or float(grad[off].max()) > 1e-4 * float(grad.max())
                  or float(diff[off].max()) > 2 * lr * (1 + 1e-3)):
            raise AssertionError(f"{label}: {n} elements of a leaf of "
                                 f"{off.numel()} off by up to "
                                 f"{float(diff.max())}")
        moved += n
    return moved


def _smoke_step(arch, dev, *, remat="block", opt=False):
    """One float32 compressed train step of ``arch``'s smoke config (after
    ``apply_opt`` with ``opt``) on ``dev`` from the same state (made on the
    CPU) and batch (with patches or frames from a numpy seed for vlm and
    audio); returns the new state, the metrics and the gradients."""
    cfg = dataclasses.replace(lm_registry.get_config(arch + "-smoke"),
                              dtype="float32", remat=remat)
    if opt:
        cfg = dryrun.apply_opt(cfg)
    tcfg = TL.TrainConfig(optimizer=O.AdamWConfig(lr=CHECK_LR,
                                                  warmup_steps=2,
                                                  total_steps=50),
                          compression=GC.CompressionConfig(rho=0.1))
    state = TL.init_train_state(torch.Generator().manual_seed(2), cfg, tcfg,
                                device="cpu")
    state = TL.TrainState(*(ckpt._map_with_path(x, lambda _, t: t.to(dev))
                            for x in state))
    batch = DP.SyntheticLM(DP.DataConfig(
        seq_len=70, global_batch=2, vocab_size=cfg.vocab_size)).batch(0)
    if cfg.family == "vlm":
        batch["patches"] = frontend(cfg, 2, cfg.frontend.n_tokens, 21)
    if cfg.family == "audio":
        batch["frames"] = frontend(cfg, 2, cfg.encdec.encoder_seq, 22)
    grads = TL.grads_of(state.params, cfg, batch)[2]
    new, metrics = TL.make_train_step(cfg, tcfg)(state, batch)
    return cfg, new, metrics, grads, batch


def phase_train_checks(dev, root) -> None:
    """Training cross-checks at the smoke size, TF32 off. (1) One float32
    compressed step of internlm2, mamba2, deepseek-v2-lite (SSD and gate
    kernels on the card), phi-3-vision (with patches), seamless-m4t (with
    frames) and zamba2 (the SSD kernel and the shared block) against the
    CPU's plain step: loss and grad norm within 1e-4 (relative), every
    updated leaf as TRAIN_LEAF_TOL says; and deepseek-v2-lite's step under
    ``apply_opt`` (``--opt``: capacity factor 1.0, so assignments drop)
    the same way. (2) Remat on (``torch.utils.checkpoint``) against remat
    off on the card: loss, gradients and updated leaves bit for bit. (3)
    On the card, every leaf of every layer (deepseek: every layer's MoE
    router) gets a non-zero gradient from the cross-entropy alone (the
    SSD kernel and the gate once returned none). (4) A launcher run
    (mamba2-780m smoke, compression, 2 microbatches, 6 steps, checkpoints
    every 3) that fails after its 4th step and is started again equals the
    run that did not fail: losses and every leaf of the final state bit for
    bit."""
    steps = {}
    for arch in (TRAIN_DENSE, TRAIN_SSM, TRAIN_MOE, VLM_ARCH, AUDIO_ARCH,
                 HYBRID_ARCH):
        ss.reset_launches()
        mg.reset_launches()
        cfg, card, cm, cgrads, batch = _smoke_step(arch, dev)
        kernel_calls = ss.LAUNCHES["ssd_scan"] + mg.LAUNCHES["moe_gate_topk"]
        _, host, hm, hgrads, _ = _smoke_step(arch, torch.device("cpu"))
        rel = {k: abs(float(cm[k]) - float(hm[k])) / abs(float(hm[k]))
               for k in ("loss", "grad_norm")}
        if max(rel.values()) > TRAIN_CARD_CPU_TOL:
            raise AssertionError(f"train {arch}: card vs CPU {rel}")
        moved = _check_update(host.params, card.params, hgrads,
                              float(hm["lr"]), f"train {arch} card vs CPU")
        _, off, om, ograds, _ = _smoke_step(arch, dev, remat="none")
        remat_equal = float(om["loss"]) == float(cm["loss"]) and all(
            torch.equal(a, b) for a, b in
            zip(tree_leaves(off.params) + tree_leaves(ograds),
                tree_leaves(card.params) + tree_leaves(cgrads)))
        if not remat_equal:
            raise AssertionError(f"train {arch}: remat on differs from off")
        leaves = [p.detach().requires_grad_()
                  for p in tree_leaves(card.params)]
        logits, _ = lm.forward(
            tree_unflatten(card.params, leaves), cfg, batch["tokens"],
            **{k: batch[k] for k in ("patches", "frames") if k in batch})
        ce = lm.L.cross_entropy(logits, torch.as_tensor(batch["labels"],
                                                        device=dev))
        grads = torch.autograd.grad(ce, leaves, allow_unused=True)
        named = dict(zip(tree_paths(card.params), grads))
        wanted = [k for k in named if k[0] == "layers" and (
            arch != TRAIN_MOE or k[-1] == "router")]
        dead = [k for k in wanted if named[k] is None or any(
            not bool((named[k][i] != 0).any()) for i in range(cfg.n_layers))]
        if dead:
            raise AssertionError(f"train {arch}: no gradient reaches {dead}")
        steps[arch] = dict(card_vs_cpu=rel, tol=TRAIN_CARD_CPU_TOL,
                           near_zero_grad_elements_moved=moved,
                           kernel_launches=kernel_calls,
                           remat_equals_no_remat=remat_equal,
                           leaves_with_task_gradient=len(wanted))
    cfg, card, cm, _, _ = _smoke_step(TRAIN_MOE, dev, opt=True)
    _, host, hm, hgrads, _ = _smoke_step(TRAIN_MOE, torch.device("cpu"),
                                         opt=True)
    rel = {k: abs(float(cm[k]) - float(hm[k])) / abs(float(hm[k]))
           for k in ("loss", "grad_norm")}
    if max(rel.values()) > TRAIN_CARD_CPU_TOL:
        raise AssertionError(f"train {TRAIN_MOE} --opt: card vs CPU {rel}")
    steps[TRAIN_MOE + " --opt"] = dict(
        card_vs_cpu=rel, tol=TRAIN_CARD_CPU_TOL,
        capacity_factor=cfg.moe.capacity_factor, dispatch=cfg.moe.dispatch,
        near_zero_grad_elements_moved=_check_update(
            host.params, card.params, hgrads, float(hm["lr"]),
            f"train {TRAIN_MOE} --opt card vs CPU"))

    def argv(name):
        return launcher_argv(TRAIN_SSM, pathlib.Path(root) / name,
                             smoke=True, steps=6, accum=2, compress=True,
                             every=3)
    whole = train_launcher.main(argv("resume-whole"))

    class Failure(RuntimeError):
        pass

    def fail(i, state, metrics):
        if i == 3:
            raise Failure
    split_argv = argv("resume-split")
    try:
        train_launcher.main(split_argv, hooks=[fail])
        raise AssertionError("train resume: the failure was not raised")
    except Failure:
        pass
    resumed = train_launcher.main(split_argv)
    same = resumed["start"] == 3 and resumed["losses"] == \
        whole["losses"][3:] and all(
            np.array_equal(a, b) for a, b in zip(
                ckpt._flatten(resumed["state"]).values(),
                ckpt._flatten(whole["state"]).values()))
    if not same:
        raise AssertionError(f"train resume: resumed at {resumed['start']}, "
                             f"losses {resumed['losses']} vs "
                             f"{whole['losses']}")
    emit("train_checks", tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         steps=steps, resume=dict(arch=TRAIN_SSM + "-smoke", steps=6,
                                  failed_after=4, restored=3,
                                  losses=whole["losses"], bit_exact=True))


def tree_paths(tree, prefix=()) -> List[tuple]:
    """Key paths of a parameter tree, in ``tree_leaves``' order."""
    return [p for k in sorted(tree) for p in (
        tree_paths(tree[k], prefix + (k,)) if isinstance(tree[k], dict)
        else [prefix + (k,)])]


def _events_ms(fn, reps: int = 3) -> float:
    """Median ms of ``fn()`` by CUDA events (after one warm call)."""
    fn()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_train_autograd(dev, smi) -> None:
    """The kernels' autograd functions on the card at the training
    shapes. SSD: one mamba2-780m layer of a training microbatch (B = 2,
    48 heads, L = 4,096, P = 64, N = 128, chunk 128; bf16 u, b, c, f32
    log decay): the forward must be the kernel (one launch) within
    ``check_ssd``'s tolerance of the plain chunked form; its gradients
    (the plain chunked form's VJP, recomputed) against plain autograd
    through the chunked form, within 1e-5 of each gradient's scale, and
    against the float64 VJP within 2e-2 (bf16 gradients); every gradient
    non-zero; the
    backward's ms (one layer) by CUDA events. Gate: deepseek's prefill call
    (T = 8,192, E = 64, k = 6, renormalised): ids and probabilities as the
    plain version's, the gradient against autograd through the plain
    version within 1e-6, and the backward's ms."""
    rng = np.random.default_rng(12)
    cfg = lm_registry.get_config(TRAIN_SSM)
    h = cfg.ssm.n_heads(cfg.d_model)
    bsz, L, p, n = TRAIN_BATCH // TRAIN_ACCUM, TRAIN_SEQ, cfg.ssm.head_dim, \
        cfg.ssm.d_state

    def t(shape, scale=1.0, dtype=torch.bfloat16):
        return (scale * torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32))).to(dev, dtype)

    u, b, c = t((bsz * h, L, p)), t((bsz, L, n), 0.3), t((bsz, L, n), 0.3)
    ld = -torch.nn.functional.softplus(t((bsz * h, L), dtype=torch.float32))
    gy = t((bsz * h, L, p))
    ops = (u, ld, b, c)

    def grads(fn, dtype=None):
        ins = [x.detach().to(dtype or x.dtype).requires_grad_() for x in ops]
        y = fn(*ins, cfg.ssm.chunk, h)
        return y, torch.autograd.grad(y, ins, gy.to(y.dtype))

    ss.reset_launches()
    y, got = grads(ss._SSDScan.apply)
    if ss.LAUNCHES["ssd_scan"] != 1:
        raise AssertionError("ssd autograd: the forward is not one launch")
    row = check_ssd("train_layer_autograd", *ops, cfg.ssm.chunk, h,
                    timed=False)
    _, plain = grads(ss._ssd_scan_plain)
    _, exact = grads(ss._ssd_scan_plain, torch.float64)
    vs_plain, vs_f64 = [], []
    for g, gp, ge in zip(got, plain, exact):
        scale = float(ge.abs().max())
        vs_plain.append(float((g.float() - gp.float()).abs().max()) / scale)
        vs_f64.append(float((g.double() - ge).abs().max()) / scale)
        if scale == 0 or vs_plain[-1] > 1e-5 or vs_f64[-1] > 2e-2:
            raise AssertionError(f"ssd autograd: gradient off the plain VJP "
                                 f"by {vs_plain[-1]}, off the float64 VJP "
                                 f"by {vs_f64[-1]} of scale {scale}")
    ins = [x.detach().requires_grad_() for x in ops]
    y = ss._SSDScan.apply(*ins, cfg.ssm.chunk, h)
    backward_ms = _events_ms(lambda: torch.autograd.grad(
        y, ins, gy, retain_graph=True))
    forward_ms = _events_ms(lambda: ss._SSDScan.apply(*ops, cfg.ssm.chunk, h))
    del y, got, plain, exact, ins

    logits = t((MOE_PREFILL_B * MOE_PREFILL_S, 64), dtype=torch.float32)
    gp = t((logits.shape[0], 6), dtype=torch.float32)
    out = {}
    for name, fn in (("kernel", mg.moe_gate_topk),
                     ("plain", mg.moe_gate_topk_plain)):
        x = logits.clone().requires_grad_()
        probs, ids = fn(x, 6, True)
        out[name] = (probs.detach(), ids, torch.autograd.grad(probs, x, gp)[0])
    gate_err = float((out["kernel"][2] - out["plain"][2]).abs().max())
    if not torch.equal(out["kernel"][1], out["plain"][1]) or gate_err > 1e-6 \
            or float((out["kernel"][0] - out["plain"][0]).abs().max()) > 1e-6:
        raise AssertionError(f"gate autograd: off its plain version by "
                             f"{gate_err}")
    x = logits.clone().requires_grad_()
    probs, _ = mg.moe_gate_topk(x, 6, True)
    gate_backward_ms = _events_ms(lambda: torch.autograd.grad(
        probs, x, gp, retain_graph=True))
    emit("train_autograd", nvidia_smi=smi,
         ssd=dict(u=list(u.shape), b=list(b.shape), chunk=cfg.ssm.chunk,
                  heads=h, dtype="bfloat16",
                  forward_max_err_over_scale=row["max_err_over_scale"],
                  grads=["u", "log_decay", "b", "c"],
                  vs_plain_autograd_over_scale=vs_plain,
                  vs_float64_vjp_over_scale=vs_f64,
                  forward_ms=forward_ms, plain_backward_ms=backward_ms,
                  backward_is="plain chunked VJP (reference _ssd_bwd_rule)"),
         gate=dict(logits=list(logits.shape), k=6, renorm=True,
                   ids_equal=True, grad_max_abs_err=gate_err,
                   plain_backward_ms=gate_backward_ms,
                   backward_is="moe_gate_vjp (plain PyTorch)"))


# ============================================================ dry run

#: the dry run's cells on the card's host (arch, shape, two pods, --opt):
#: a dense train step, the expert-parallel decode, arctic's train state on
#: two pods, mamba2's 524,288-token decode, three cells the layout
#: repairs brought under 80 GB a rank (the plain MoE layer's expert
#: blocks, attention in blocks of queries over 24 heads whole, the
#: cross-entropy over token chunks of a 256,206-word vocabulary), arctic's
#: decode with and without --opt, which the donated serve state brings
#: under 80 GB, and zamba2's decode, whose arguments alone are over it;
#: each in a process of its own, all at once
DRYRUN_CELLS = (("internlm2-1.8b", "train_4k", False, False),
                ("deepseek-v2-lite-16b", "decode_32k", False, True),
                ("arctic-480b", "train_4k", True, True),
                ("mamba2-780m", "long_500k", False, False),
                ("deepseek-v2-lite-16b", "train_4k", False, False),
                ("llama3.2-3b", "prefill_32k", False, False),
                ("seamless-m4t-medium", "train_4k", False, False),
                ("arctic-480b", "decode_32k", False, False),
                ("arctic-480b", "decode_32k", False, True),
                ("zamba2-1.2b", "decode_32k", False, False))
#: the cells that must fit the card: arctic's decode (its state donated)
DRYRUN_MUST_FIT = (("arctic-480b", "decode_32k", False, False),
                   ("arctic-480b", "decode_32k", False, True))
#: the peak of internlm2's launcher step on an NVIDIA H100 80GB HBM3 (700
#: W) with a functional step (the old and the new state both held in
#: AdamW's update): the counter's donated step must peak below it
COUNTER_PREVIOUS_PEAK = 44_390_841_856
#: the card's peak of the counter's step against the dry run's count
COUNTER_PEAK_TOL = 0.01
#: the dry run's record keys each ``dryrun`` line carries
DRYRUN_KEYS = ("arch", "shape", "mesh", "chips", "rank", "status",
               "trace_s", "flops_per_chip", "bytes_per_chip",
               "collective_bytes_per_chip", "collectives", "memory",
               "peak_bytes", "state_bytes", "model_flops_global", "terms",
               "dominant", "useful_flops_ratio", "roofline_fraction")
#: the device memory a rank's predicted peak is held against
CARD_BYTES = 80e9

_DRYRUN_SCRIPT = """
import json, sys
from repro_torch.launch import dryrun as D
for arch, shape, pod, opt in json.loads(sys.argv[1]):
    rec = D.run_cell(arch, shape, pod, opt=opt)
    rec["opt"] = opt
    print(json.dumps(rec), flush=True)
"""


def phase_dryrun(dev, smi, root) -> None:
    """The dry run (:mod:`repro_torch.launch.dryrun`) on this machine's
    host: each of :data:`DRYRUN_CELLS` traced as rank 0 of its production
    mesh under ``FakeTensorMode`` (a subprocess, whose fake process group
    is its own; nothing runs on the card), one ``dryrun`` line each, status
    ``ok`` or raise (:data:`DRYRUN_MUST_FIT` at most 80 GB a rank). Then
    the counter against the card, on internlm2-1.8b's launcher step (8 x
    4,096 tokens in 4 microbatches, one device, the state donated as the
    launcher donates it; its peak below :data:`COUNTER_PREVIOUS_PEAK` or
    raise): the dry run's count of that step on fake CPU tensors
    (:func:`repro_torch.launch.dryrun.measure`) against one real step on
    the card — the argument bytes equal to the real state's bytes, the
    FLOPs equal to ``FlopCounterMode`` around the real step (any
    difference named op by op, then raised), ``torch.cuda.
    max_memory_allocated`` of that step within :data:`COUNTER_PEAK_TOL` of
    the predicted peak, and the predicted compute and memory terms beside
    the measured time of a second step. The step takes the fused
    attention kernel, as the launcher does (its operator counted at its
    model FLOPs on both sides; one launch a layer in each microbatch's
    forward and recompute). The two donated steps must equal two
    functional ones from the same initial state: losses and each leaf's
    checksum (:func:`leaf_checksums`)."""
    import os
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    t0 = time.perf_counter()
    # the cells run on the host beside the counter's work below
    procs = [subprocess.Popen(
        [sys.executable, "-c", _DRYRUN_SCRIPT, json.dumps([cell])],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT) for cell in DRYRUN_CELLS]
    recs = []
    try:
        counter = _dryrun_counter(dev, smi, root)
        for proc in procs:
            out, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"dryrun: {err[-3000:]}")
            recs += [json.loads(line) for line in out.splitlines()
                     if line.startswith("{")]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if len(recs) != len(DRYRUN_CELLS) or any(r["status"] != "ok"
                                             for r in recs):
        raise AssertionError(f"dryrun: {recs}")
    for rec in recs:
        cell = (rec["arch"], rec["shape"], rec["mesh"] == "2x16x16",
                rec["opt"])
        if cell in DRYRUN_MUST_FIT and rec["peak_bytes"] > CARD_BYTES:
            raise AssertionError(f"dryrun: {cell} peaks at "
                                 f"{rec['peak_bytes']} a rank")
        emit("dryrun", **{k: rec[k] for k in DRYRUN_KEYS}, opt=rec["opt"],
             fits_card=rec["peak_bytes"] <= CARD_BYTES, card_bytes=CARD_BYTES,
             device="none: fake ranks under FakeTensorMode on the host",
             constants=dict(peak_flops=roofline.PEAK_FLOPS,
                            hbm_bw=roofline.HBM_BW,
                            link_bw=roofline.LINK_BW),
             nvidia_smi=smi)
    emit("dryrun", **counter,
         previous_max_memory_allocated=COUNTER_PREVIOUS_PEAK,
         phase_s=time.perf_counter() - t0)
    if counter["max_memory_allocated"] >= COUNTER_PREVIOUS_PEAK:
        raise AssertionError(f"dryrun: internlm2's step peaks at "
                             f"{counter['max_memory_allocated']}, not below "
                             f"{COUNTER_PREVIOUS_PEAK}")
    if abs(counter["peak_ratio"] - 1) > COUNTER_PEAK_TOL:
        raise AssertionError(f"dryrun: internlm2's step peaks at "
                             f"{counter['max_memory_allocated']}, "
                             f"{counter['peak_ratio']} of the predicted "
                             f"{counter['predicted_peak_bytes']}")
    if counter["max_memory_allocated"] \
            >= counter["functional_max_memory_allocated"]:
        raise AssertionError(f"dryrun: the donated step's peak "
                             f"{counter['max_memory_allocated']} is not "
                             f"below the functional step's")
    if not counter["donated_equals_functional"]:
        raise AssertionError(f"dryrun: the donated steps' losses "
                             f"{counter['losses']} or checksums differ from "
                             f"the functional steps' "
                             f"{counter['functional_losses']}")
    if counter["argument_bytes"] != counter["real_state_bytes"]:
        raise AssertionError(f"dryrun: argument bytes "
                             f"{counter['argument_bytes']} against the "
                             f"card's state {counter['real_state_bytes']}")
    if counter["attention_launches"] \
            != counter["attention_launches_expected"]:
        raise AssertionError(f"dryrun: the step launched the fused "
                             f"attention kernel "
                             f"{counter['attention_launches']} times, "
                             f"expected "
                             f"{counter['attention_launches_expected']}")
    if counter["flops"] != counter["real_flops"]:
        raise AssertionError(f"dryrun: FLOPs {counter['flops']} against "
                             f"the card's {counter['real_flops']}: "
                             f"{counter['flops_diff_by_op']}")


def leaf_checksums(state) -> Dict[str, int]:
    """Each tensor leaf's bit patterns summed as int64 (mod 2 ** 64: exact
    in any order), by checkpoint key: two states whose leaves differ in
    any element differ here but for a collision."""
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    out: Dict[str, int] = {}

    def one(key, leaf):
        if isinstance(leaf, torch.Tensor):
            bits = leaf.reshape(-1).view(ints[leaf.element_size()])
            out[key] = int(torch.sum(bits, dtype=torch.int64))
        return leaf
    ckpt._map_with_path(state, one)
    return out


def _dryrun_counter(dev, smi, root) -> Dict[str, Any]:
    """The counter against the card (see :func:`phase_dryrun`): the
    ``counter_vs_card`` line's fields."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    args = train_launcher.parser().parse_args(launcher_argv(
        TRAIN_DENSE, pathlib.Path(root) / "dryrun", seq=TRAIN_SEQ,
        batch=TRAIN_BATCH))
    cfg, tcfg, data = train_launcher.setup(args)
    # the launcher's step: its state donated
    step = TL.make_train_step(cfg, tcfg, donate=True)
    batch = data.batch(0)
    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = TL.init_train_state(torch.Generator().manual_seed(0), cfg,
                                   tcfg, "cpu")
        pred = dryrun.measure(step, (fake, batch), tensor_bytes(fake),
                              tensor_bytes(fake))
        del fake
    state = TL.init_train_state(torch.Generator(device=dev).manual_seed(0),
                                cfg, tcfg, dev)
    real_bytes = tensor_bytes(state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    # the fused attention kernel is the operator repro::gqa_attention,
    # counted at its model FLOPs here as on the fake tensors
    reset_launches()
    with FlopCounterMode(display=False) as counter:
        state, m0 = step(state, batch)
    torch.cuda.synchronize()
    attention = ga.LAUNCHES[ATTENTION_KERNEL]
    peak = torch.cuda.max_memory_allocated()
    real_by_op = {str(k): int(v) for k, v in
                  counter.get_flop_counts().get("Global", {}).items()}
    real_flops = int(counter.get_total_flops())
    t1 = time.perf_counter()
    state, m1 = step(state, data.batch(1))
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t1
    losses = [float(m0["loss"]), float(m1["loss"])]
    sums = leaf_checksums(state)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    # the same two steps functional, from the same initial state
    functional = TL.make_train_step(cfg, tcfg)
    state = TL.init_train_state(torch.Generator(device=dev).manual_seed(0),
                                cfg, tcfg, dev)
    torch.cuda.reset_peak_memory_stats()
    f_losses = []
    for i in range(2):
        state, m = functional(state, data.batch(i))
        f_losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    f_peak = torch.cuda.max_memory_allocated()
    f_sums = leaf_checksums(state)
    del state, m
    gc.collect()
    torch.cuda.empty_cache()
    diff = {op: (pred["flops_by_op"].get(op, 0), real_by_op.get(op, 0))
            for op in set(pred["flops_by_op"]) | set(real_by_op)
            if pred["flops_by_op"].get(op, 0) != real_by_op.get(op, 0)}
    compute_s = pred["flops"] / roofline.PEAK_FLOPS
    memory_s = pred["bytes"] / roofline.HBM_BW
    return dict(run="counter_vs_card", arch=cfg.name, seq=TRAIN_SEQ,
                global_batch=TRAIN_BATCH, grad_accum=tcfg.grad_accum,
                argument_bytes=pred["memory"]["argument_bytes"],
                real_state_bytes=real_bytes, flops=pred["flops"],
                real_flops=real_flops, flops_by_op=pred["flops_by_op"],
                flops_diff_by_op=diff,
                predicted_peak_bytes=pred["peak_bytes"],
                predicted_memory=pred["memory"],
                max_memory_allocated=peak, memory_allocated_before=base,
                peak_ratio=peak / pred["peak_bytes"], donate=True,
                attention_launches=attention,
                attention_launches_expected=gqa_train_calls(
                    cfg, tcfg.grad_accum),
                losses=losses, functional_losses=f_losses,
                functional_max_memory_allocated=f_peak,
                leaves_checked=len(sums),
                donated_equals_functional=losses == f_losses
                and sums == f_sums,
                predicted_bytes=pred["bytes"], compute_s=compute_s,
                memory_s=memory_s, step_s=step_s,
                compute_fraction=compute_s / step_s,
                roofline_fraction=max(compute_s, memory_s) / step_s,
                trace_s=pred["trace_s"], nvidia_smi=smi)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    # the durability paths' snapshots, inside the checkout's build tree
    # (ignored by git) and removed at the end
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="snapshots-",
                                     dir=ROOT / "build") as root:
        return smoke(root)


def smoke(root: str) -> int:
    """Every phase on the card; snapshot directories go under ``root``."""
    dev = torch.device("cuda")
    # full float32 products for the float32 cross-checks
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    t0 = time.perf_counter()
    build.build_all(list(SOURCES))
    rn._library()
    ut._library()
    ss._library()
    mg._library()
    build_s = time.perf_counter() - t0
    ptxas = {name: ptxas_report(name) for name in SOURCES}
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), nvidia_smi=smi,
         kernel_build_s=build_s, ptxas=ptxas,
         tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         tf32_cudnn=torch.backends.cudnn.allow_tf32)

    streams = synth_clients(N_CLIENTS)
    ff = serve_network()
    p_ff = network.init_network(torch.Generator().manual_seed(0), ff,
                                device=dev)
    lm_cfg = lm_registry.get_config(LM_ARCH)
    lm_params = lm.init_params(torch.Generator(device=dev).manual_seed(0),
                               lm_cfg, device=dev)
    lm_tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, lm_cfg.vocab_size, (PREFILL_B, PREFILL_L))).to(dev)
    prompts = lm_prompts()
    moe_cfg = lm_registry.get_config(MOE_ARCH)
    moe_params = lm.init_params(torch.Generator(device=dev).manual_seed(0),
                                moe_cfg, device=dev)
    moe_tokens = torch.from_numpy(np.random.default_rng(10).integers(
        0, moe_cfg.vocab_size, (MOE_PREFILL_B, MOE_PREFILL_S))).to(dev)
    moe_requests = requests(moe_cfg.vocab_size, MOE_REQUESTS, MOE_MAX_PROMPT,
                            0)
    served: Dict[str, Any] = {}
    paths = main_paths(dev, streams, ff, p_ff, served) + learn_paths(
        dev, streams, ff, p_ff, served) + durability_paths(
        dev, streams, ff, p_ff, served, root) + column_paths(dev) + lm_paths(
        dev, lm_cfg, lm_params, lm_tokens, prompts) + moe_paths(
        dev, moe_cfg, moe_params, moe_tokens, moe_requests)
    # capture pass (also the warm-up): each path's calls and operands
    # (the generation path launches no kernel: its measured run shows it)
    # the prefill (paths[0]) is captured, and so warmed, even without a
    # kernel; an engine path without one (host-bound, seconds a run) is not
    captured = {path.name: capture(path.run)
                if path.kernel or path is paths[0] else [] for path in paths}
    floor_ms = launch_floor_ms()
    emit("kernels", variant="launch_floor", op="fill_ of one float32 "
         "element", ms=floor_ms, ms_source="profiler")
    main_rows = phase_kernels(dev, captured, floor_ms)
    launches = phase_serve(paths, captured)
    phase_learn_ratio(dev, streams, ff, p_ff, root)
    phase_profile(dev, streams, ff, p_ff)
    phase_profile_learn(dev, streams, ff, p_ff)
    for path in paths:
        if path.name.startswith("gate_level") \
                or path.name in ("lm_prefill", "moe_prefill"):
            phase_profile_path(path)
    mesh_launches, mesh_rows = phase_mesh(dev, streams, ff, p_ff, served,
                                          launches, root)
    phase_lm_prefill(lm_cfg, lm_params, lm_tokens)
    phase_profile_decode(lm_cfg, lm_params, prompts)
    phase_lm_checks(dev, lm_cfg, lm_params, lm_tokens, prompts)
    phase_lm_prefill(moe_cfg, moe_params, moe_tokens, "moe_prefill_time")
    phase_profile_decode(moe_cfg, moe_params, moe_requests[:MOE_SLOTS],
                         "moe_decode_step", per_slot=True)
    phase_moe_checks(dev, moe_cfg, moe_params)
    lm_mesh_launches, lm_mesh_kernels, tp_rows = phase_lm_mesh(
        dev, moe_cfg, moe_params, moe_tokens, root,
        (lm_cfg, lm_params, lm_tokens), floor_ms)
    launches.update(lm_mesh_launches)

    ssd = main_rows["ssd_scan"]
    ssd_row = dict(ptxas=ptxas["ssd_scan"], tp_tiles=[{
        k: row[k] for k in ("model", "u", "max_abs_err", "ms", "ms_source",
                            "plain_ms", "bound_ms", "bound_by", "calls")}
        for row in tp_rows], occupancy={
        str(dt).split(".")[-1]: dict(zip(
            ("smem_bytes", "blocks_per_sm"),
            ss.kernel_occupancy(ssd["chunk"], ssd["n"], dt)))
        for dt in (torch.bfloat16, torch.float32)})
    kernel_of = {path.name: path.kernel for path in paths}
    kernel_of.update(lm_mesh_kernels)

    # the last three LM families and training: the inference models and
    # the captured operands go first (deepseek's parameters alone hold
    # 32 GB); then one family's model at a time
    del paths, path, captured, lm_params, moe_params, lm_tokens, moe_tokens
    gc.collect()
    torch.cuda.empty_cache()
    for arch in (VLM_ARCH, AUDIO_ARCH, HYBRID_ARCH):
        family_launches, family_kernels = phase_family(dev, arch, root)
        launches.update(family_launches)
        kernel_of.update(family_kernels)
        gc.collect()
        torch.cuda.empty_cache()
    phase_gqa_attention(dev, smi)
    phase_attention(dev, smi)
    phase_train_checks(dev, root)
    phase_train_autograd(dev, smi)
    train = train_paths(root, smi)
    train_launches, train_captured, mesh_train_kernels = phase_train(
        train, smi, root)
    launches.update(train_launches)
    kernel_of.update({path.name: path.kernel for path, _ in train})
    kernel_of.update(mesh_train_kernels)
    for path, cases in train_captured.items():
        for i, case in enumerate(cases):
            if case["wrapper"] == "ssd_scan":
                for k, ops in enumerate(case["operands"]):
                    check_ssd(f"{path}#{i}/call{k}", *ops, case["chunk"],
                              case["heads"], timed=k == 0, path=path,
                              calls=case["calls"])
            elif case["wrapper"] == "moe_gate_topk":
                check_gate(f"{path}#{i}", case["logits"], case["k"],
                           case["renorm"], path=path, calls=case["calls"],
                           floor_ms=floor_ms)
    del train_captured
    phase_dryrun(dev, smi, root)

    kernels = []
    for name, row in main_rows.items():
        by_run = {run: launches[run][name] for run, kernel in
                  kernel_of.items() if kernel == name}
        source = SOURCES[SOURCE_OF[name]]
        kernels.append(dict(
            name=name, route="cuda", source=source,
            replaces=REPLACES[name], launches=sum(by_run.values()),
            launches_by_run=by_run, shape=row["shape"],
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            ms_source=row["ms_source"],
            kernels_per_call=row["kernels_per_call"],
            plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row.get("library_ms"), floor_ms=floor_ms,
            **(ssd_row if name == "ssd_scan" else {})))
    for name, row in mesh_rows.items():
        by_run = {run: counts[name] for run, counts in mesh_launches.items()
                  if counts[name]}
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES["rnl_neuron"],
            wrapper=MESH_WRAPPER_SOURCE, replaces=MESH_REPLACES[name],
            launches=sum(by_run.values()), launches_by_run=by_run,
            shape=f"L{row['layer']} mesh {row['mesh']}",
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            ms_source=row["ms_source"],
            kernels_per_call=row["kernels_per_call"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=None, floor_ms=floor_ms,
            tiles=row["tiles"]))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
