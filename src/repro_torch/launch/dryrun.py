"""Dry run over the production meshes, and the launcher's ``--opt`` layout
transform, ``apply_opt``.

For every (architecture x input shape x mesh) cell the dry run builds the
real step of one rank — the mesh train step, the prefill forward or the
mesh decode step — on the reference's production meshes (``(16, 16)``
and ``(2, 16, 16)``, :mod:`repro_torch.launch.mesh`), with the state laid
out as the reference's dry run lays it out (``param_pspecs``,
``serve_shardings``, batch-split inputs), and runs it once as rank 0 of a
fake process group under ``FakeTensorMode``: every tensor is a fake CPU
tensor, so nothing is computed or allocated on any device, and every
kernel wrapper takes its plain version (the reference's dry run sets
``REPRO_KERNEL_IMPL=ref`` for the same reason). The run is counted by
:class:`repro_torch.roofline.op_cost.OpCost`, and each cell records
per-rank FLOPs, bytes and collective bytes, the memory it holds, and the
roofline terms (:mod:`repro_torch.roofline.analysis`).

The reference lowers and compiles each step with XLA and reads its cost
and memory analyses; here the step runs op by op on fake tensors. So a
record has ``trace_s`` where the reference's has ``lower_s`` and
``compile_s``, no ``raw_cost_analysis``, and ``code_bytes`` null. Its
``memory`` counts the arguments as the reference's in-shardings do (the
state's blocks and the rank's block of the batch), the outputs (those
that are a donated argument's tensors once, as ``alias_bytes``), and as
temporaries the most the step held beyond both; ``peak_bytes`` is the
most it held at once. The train and decode steps donate their state, as
the reference's jit does.

Results go to ``experiments/dryrun_torch/<mesh><tag>.json``, appended cell
by cell, so an interrupted sweep resumes where it left off.

Usage:
  python -m repro_torch.launch.dryrun --arch glm4-9b --shape train_4k \
      [--multi-pod] [--opt]
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--force]

``apply_opt`` is a pure config transform. On one device only the MoE
settings change what runs (capacity factor 1.0; ``catwalk_ep`` dispatch,
which runs ``moe_apply`` without a mesh, as the reference does). Under a
``("data", "model")`` mesh ``catwalk_ep`` runs the expert-parallel layer
and ``batch_over_model`` splits the rows over ``model`` too; ``act_sp``
keeps each rank's block of the sequence between the layers (sequence
parallelism, :func:`repro_torch.models.transformer.forward`).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time
import traceback
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.base import (SHAPES, SHAPES_BY_NAME, ModelConfig,
                                      ShapeConfig)
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.launch.input_specs import cell_is_applicable, input_specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as T
from repro_torch.optim import optimizers as O
from repro_torch.optim.tree import tree_map
from repro_torch.roofline import analysis as R
from repro_torch.roofline.op_cost import OpCost, aliased_bytes, tensor_bytes
from repro_torch.sharding import specs as SH
from repro_torch.train import train_loop as TL

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[3] / "experiments" \
    / "dryrun_torch"


def apply_opt(cfg: ModelConfig) -> ModelConfig:
    """Beyond-baseline layout (--opt): per-family settings from the
    reference's layout search. The paper-baseline layout stays the
    default."""
    repl = {}
    if cfg.family in ("ssm", "hybrid"):
        repl["batch_over_model"] = True      # batch over every device
    elif cfg.resolved_head_dim % 128 == 0:
        # sequence-parallel activations pay off only for head dims that
        # are multiples of 128 (glm4, llama, internlm, arctic, deepseek)
        repl["act_sp"] = True
    if cfg.moe is not None:
        # expert-parallel relocation dispatch
        repl["moe"] = dataclasses.replace(
            cfg.moe, capacity_factor=1.0, dispatch="catwalk_ep",
            ep_fsdp=cfg.param_count() > 100e9)
    return dataclasses.replace(cfg, **repl)


def train_config(cfg: ModelConfig, opt: bool) -> TL.TrainConfig:
    """The reference dry run's production train config: 8 microbatches
    above 100 B parameters without ``--opt`` (the expert-parallel layout
    drops them), bf16 moments above 100 B."""
    big = cfg.param_count() > 100e9
    return TL.TrainConfig(
        grad_accum=8 if (big and not opt) else 1,
        optimizer=O.AdamWConfig(
            moments_dtype="bfloat16" if big else "float32"))


def _inputs(specs: Dict[str, torch.Tensor], cfg: ModelConfig, device,
            generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Tensors on ``device`` for the ``meta`` stand-ins: token ids in the
    vocabulary, normal draws for patches and frames (under
    ``FakeTensorMode``: fake tensors, nothing drawn)."""
    out = {}
    for k, v in specs.items():
        if v.dtype == torch.int32:
            out[k] = torch.randint(0, cfg.vocab_size, tuple(v.shape),
                                   generator=generator, dtype=torch.int32
                                   ).to(device)
        else:
            out[k] = torch.randn(tuple(v.shape), generator=generator).to(
                device=device, dtype=v.dtype)
    return out


def _block_bytes(batch: Dict[str, torch.Tensor], mesh, over_model: bool
                 ) -> int:
    """The bytes of the rank's block of each batch entry under the
    reference's ``data_shardings``."""
    specs = SH.data_shardings(mesh, batch, over_model=over_model)
    return sum(
        torch.Size(SH.block_shape(v.shape, specs[k], mesh)).numel()
        * v.element_size() for k, v in batch.items())


def build_step(cfg: ModelConfig, shape: ShapeConfig, mesh, opt: bool = False,
               device="cpu", seed: int = 0
               ) -> Tuple[Callable, Tuple[Any, ...], int]:
    """One rank's step of the cell and its arguments, as the reference's
    dry run builds the cell (``build_lowered``): ``(step, args,
    argument_bytes)``, the step called as ``step(*args)``; under
    ``FakeTensorMode`` every tensor is fake. ``cfg``: with ``apply_opt``
    already applied under ``opt``.

    * train: the mesh train step (:func:`train_config`; its gradients end
      in the parameters' layout, which the reference pins under ``--opt``
      alone) on a state made as blocks, the whole batch in, the state
      donated (the reference's ``donate_argnums=(0,)``);
    * prefill: ``forward(..., logits_mode="last", mesh=)`` without a
      gradient on the rank's rows (the batch over the DP axes, and
      ``model`` under ``batch_over_model``), the parameters under
      ``param_pspecs``, each gathered as far as ``tp_plan`` leaves it
      whole;
    * decode: ``decode_step(..., mesh=, donate=True)`` without a gradient
      on a serve state of the shape's length (``init_serve_state(mesh=)``;
      audio encodes its frames there; donated, as the reference's
      ``donate_argnums=(1,)``), the parameters under ``serve_pspecs``, the
      tokens whole.

    ``argument_bytes``: the state's blocks and the rank's block of the
    batch, the bytes of the reference's in-shardings."""
    gen = torch.Generator().manual_seed(seed)
    batch = _inputs(input_specs(cfg, shape), cfg, device, gen)
    if shape.kind == "train":
        tcfg = train_config(cfg, opt)
        state = TL.init_train_state(gen, cfg, tcfg, device, mesh=mesh)
        step = TL.make_train_step(cfg, tcfg, mesh=mesh, donate=True)
        return step, (state, batch), tensor_bytes(state) + _block_bytes(
            batch, mesh, cfg.batch_over_model)
    if shape.kind == "prefill":
        pspecs = SH.param_pspecs(
            T.init_params(torch.Generator(), cfg, device="meta"), mesh)
        params = T.init_params(gen, cfg, device,
                               cut=T.block_cut(pspecs, mesh))
        fetch = tree_map(SH.spec_minus, pspecs, T.tp_plan(cfg, mesh))

        def prefill(params, batch):
            b = batch["tokens"].shape[0]
            rows = SH.lm_row_axes(mesh, b, cfg.batch_over_model)
            mine = SH.block_slice(mesh, b, rows or None)
            whole = tree_map(lambda p, f: SH.gather(p, f, mesh), params,
                             fetch)
            extra = {k: v[mine] for k, v in batch.items() if k != "tokens"}
            with torch.no_grad():
                logits, _ = T.forward(whole, cfg, batch["tokens"][mine],
                                      logits_mode="last", mesh=mesh,
                                      batch_axes=rows, **extra)
            return logits
        return prefill, (params, batch), tensor_bytes(params) + _block_bytes(
            batch, mesh, cfg.batch_over_model)
    params = T.init_params(gen, cfg, device,
                           cut=T.block_cut(T.serve_pspecs(cfg, mesh), mesh))
    b = shape.global_batch
    frames = None
    if cfg.family == "audio":
        frames = _inputs({"frames": torch.empty(
            (b, cfg.encdec.encoder_seq, cfg.frontend.d_embed),
            dtype=torch.bfloat16, device="meta")}, cfg, device, gen)["frames"]
    with torch.no_grad():
        state = T.init_serve_state(params, cfg, b, shape.seq_len,
                                   frames=frames, mesh=mesh)

    def decode(params, state, tokens):
        with torch.no_grad():
            return T.decode_step(params, cfg, state, tokens, mesh=mesh,
                                 donate=True)
    return decode, (params, state, batch["tokens"]), tensor_bytes(
        params) + tensor_bytes(state) + _block_bytes(batch, mesh, False)


def measure(step: Callable, args: Tuple[Any, ...], arg_bytes: int,
            state_bytes: int) -> Dict[str, Any]:
    """Run ``step(*args)`` once under :class:`OpCost` (its arguments held
    through it) and return the counts, the memory (``arg_bytes`` as the
    arguments' bytes, the outputs' bytes, of which ``alias_bytes`` those of
    outputs whose storage is an argument's (a donated state, XLA's
    ``alias_size_in_bytes``), as temporaries the most held beyond the
    arguments and the outputs that are not an argument's),
    ``state_bytes`` and the run's host time. Call it inside
    ``FakeTensorMode`` to count without computing."""
    cost = OpCost()
    cost.hold(args)
    held = cost.live_bytes
    t0 = time.perf_counter()
    with cost:
        out = step(*args)
    trace_s = time.perf_counter() - t0
    out_bytes = tensor_bytes(out)
    alias_bytes = aliased_bytes(out, args)
    del out
    return {
        "trace_s": trace_s, "flops": cost.flops, "bytes": cost.bytes,
        "state_bytes": state_bytes,
        "flops_by_op": cost.flops_by_op,
        "collectives": cost.collectives,
        "collective_bytes": cost.collective_bytes,
        "peak_bytes": cost.peak_bytes,
        "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                   "alias_bytes": alias_bytes,
                   "temp_bytes": max(cost.peak_bytes - held - out_bytes
                                     + alias_bytes, 0),
                   "code_bytes": None}}


def trace_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, opt: bool = False,
               *, fake: bool = True) -> Dict[str, Any]:
    """Build the cell's step on ``mesh`` (this process's rank of it) and
    :func:`measure` it: under ``FakeTensorMode`` with ``fake`` (nothing
    computed or allocated), else on real CPU tensors. The state's bytes
    are those of the train state, the prefill's parameters or the
    decode's serve state."""
    import contextlib
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = FakeTensorMode(allow_non_fake_inputs=True) if fake \
        else contextlib.nullcontext()
    with mode:
        step, args, arg_bytes = build_step(cfg, shape, mesh, opt)
        return measure(step, args, arg_bytes, tensor_bytes(
            args[1] if shape.kind == "decode" else args[0]))


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             opt: bool = False) -> dict:
    cfg = get_config(arch)
    if opt:
        cfg = apply_opt(cfg)
    shape = SHAPES_BY_NAME[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.mesh.numel()
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "x".join(map(str, mesh.shape)), "chips": chips,
           "rank": 0, "status": "n/a"}
    if not cell_is_applicable(cfg, shape):
        rec["status"] = "skipped"
        rec["reason"] = ("long_500k needs sub-quadratic attention; "
                         f"{arch} is full-attention (DESIGN.md §4)")
        return rec
    got = trace_cell(cfg, shape, mesh, opt)
    mf = R.model_flops(cfg, shape)
    terms = R.compute_terms(flops_per_chip=got["flops"],
                            bytes_per_chip=got["bytes"],
                            coll_bytes_per_chip=got["collective_bytes"],
                            chips=chips, model_flops_global=mf)
    rec.update({
        "status": "ok", "trace_s": round(got["trace_s"], 1),
        "flops_per_chip": float(got["flops"]),
        "bytes_per_chip": float(got["bytes"]),
        "collective_bytes_per_chip": float(got["collective_bytes"]),
        "collectives": {k: v for k, v in got["collectives"].items() if v},
        "memory": got["memory"], "peak_bytes": got["peak_bytes"],
        "state_bytes": got["state_bytes"],
        "model_flops_global": mf,
        "terms": {"compute_s": terms.compute_s, "memory_s": terms.memory_s,
                  "collective_s": terms.collective_s},
        "dominant": terms.dominant,
        "useful_flops_ratio": terms.useful_flops_ratio,
        "roofline_fraction": terms.roofline_fraction,
    })
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS))
    ap.add_argument("--shape", choices=[s.name for s in SHAPES])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--force", action="store_true",
                    help="recompute cells already in the results file")
    ap.add_argument("--tag", default="", help="results file suffix")
    ap.add_argument("--opt", action="store_true",
                    help="apply the beyond-baseline layout (apply_opt)")
    args = ap.parse_args()
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    mesh_name = "2x16x16" if args.multi_pod else "16x16"
    tag = args.tag + ("_opt" if args.opt else "")
    out_path = RESULTS_DIR / f"{mesh_name}{tag}.json"
    results = {}
    if out_path.exists():
        results = json.loads(out_path.read_text())

    cells = ([(args.arch, args.shape)] if args.arch and args.shape else
             [(a, s.name) for a in ARCH_IDS for s in SHAPES])
    for arch, shape_name in cells:
        key = f"{arch}|{shape_name}"
        if key in results and results[key].get("status") in ("ok", "skipped") \
                and not args.force:
            print(f"[skip-cached] {key}")
            continue
        print(f"[cell] {key} mesh={mesh_name} ...", flush=True)
        try:
            rec = run_cell(arch, shape_name, args.multi_pod, opt=args.opt)
        except Exception as e:  # noqa: BLE001 — record the failure and go on
            rec = {"arch": arch, "shape": shape_name, "status": "error",
                   "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-2000:]}
        results[key] = rec
        out_path.write_text(json.dumps(results, indent=1))
        status = rec["status"]
        extra = (f" dominant={rec.get('dominant')} "
                 f"roofline={rec.get('roofline_fraction', 0):.3f} "
                 f"peak={rec.get('peak_bytes', 0) / 1e9:.2f}GB"
                 if status == "ok" else rec.get("reason", rec.get("error", "")))
        print(f"[done] {key}: {status} {extra}", flush=True)

    n_ok = sum(1 for r in results.values() if r["status"] == "ok")
    n_skip = sum(1 for r in results.values() if r["status"] == "skipped")
    n_err = sum(1 for r in results.values() if r["status"] == "error")
    print(f"\n=== {mesh_name}: {n_ok} ok, {n_skip} skipped (documented), "
          f"{n_err} errors -> {out_path}")


if __name__ == "__main__":
    main()
