"""Rank bodies of the port's LM mesh tests (``tests/test_torch_lm_mesh.py``),
run by :func:`_torch_dist.run` with ``kind="lm"`` on a ``("data",
"model")`` mesh of spawned gloo ranks. They import torch and the port
only. Inputs cross as numpy; each body returns numpy arrays and plain
values, the whole tensors from the rank at the mesh origin.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np


def _np(t) -> np.ndarray:
    return t.detach().float().numpy()


def _tree(arrays: Dict[str, Any]):
    import torch
    return {k: _tree(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in arrays.items()}


def _rows(mesh, x, axes=None):
    """This rank's block of ``x``'s leading axis over the DP axes."""
    from repro_torch.sharding import specs
    entry = specs.live_axes(mesh, specs.dp_axes(mesh) if axes is None
                            else axes) or None
    return x[specs.block_slice(mesh, x.shape[0], entry)], entry


# ------------------------------------------------------------- the EP layer

def ep_suite(mesh, cases) -> Dict[str, Any]:
    """Each case: an MoE config, whole parameters and rows; ``tnn``: run it
    on a ``("data", "column")`` mesh of the same shape (no ``model``
    axis); ``grad``: also the gradients of ``sum(out * weights)`` (plus
    the aux loss where the data axis has one rank), summed over the ranks
    that hold the same block, and gathered whole. Every case runs
    ``moe_apply_ep`` with the rank's blocks of the parameters and its
    rows."""
    import torch
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models import moe as M
    from repro_torch.sharding import specs
    from repro_torch.train.checkpoint import _map_with_path
    tnn = None
    out: Dict[str, Any] = {}
    for name, c in cases.items():
        cfg = MoEConfig(**c["cfg"])
        m = mesh
        if c.get("tnn"):
            if tnn is None:
                tnn = specs.tnn_mesh(mesh.shape[1], mesh.shape[0],
                                     device_type="cpu")
            m = tnn
        p = _tree(c["p"])
        x, entry = _rows(m, torch.from_numpy(c["x"]))
        ep = M.ep_model_size(cfg, m) is not None
        bspecs = M.ep_block_specs(cfg, m, c["fsdp"]) if ep else {}
        spec_of = {}

        def block(key, leaf):
            spec = bspecs.get(key, (None,) * leaf.dim())
            spec_of[key] = spec
            return specs.shard_of(leaf, spec, m).requires_grad_()
        pb = _map_with_path(p, block)
        x.requires_grad_()
        y, stats = M.moe_apply_ep(pb, x, cfg, fsdp=c["fsdp"], mesh=m)
        res = dict(ep=ep, y=_np(specs.gather(y, (entry, None, None), m)),
                   aux=float(stats["aux_loss"].detach()))
        if c.get("grad"):
            w, _ = _rows(m, torch.from_numpy(c["w"]))
            loss = torch.sum(y * w)
            if specs.axis_size(m, specs.dp_axes(m)) == 1:
                loss = loss + stats["aux_loss"]
            loss.backward()
            dp = specs.live_axes(m, specs.dp_axes(m))

            def whole(key, leaf):
                spec = spec_of[key]
                g = specs.all_reduce(leaf.grad, tuple(
                    a for a in dp if a not in specs.spec_axes(spec)), m)
                return _np(specs.gather(g, spec, m))
            res["grads"] = _map_with_path(pb, whole)
            res["x_grad"] = _np(specs.gather(x.grad, (entry, None, None), m))
        out[name] = res
    return out


def plain_moe_suite(mesh, cases) -> Dict[str, Any]:
    """Each case: an MoE config (catwalk dispatch), whole parameters, rows
    ``x`` and loss weights ``w``. Every rank takes its blocks of the
    expert stacks under ``moe.plain_block_specs`` (the router and the
    shared experts whole) and its rows over the DP axes, runs
    ``moe_apply(..., mesh=)`` and returns: the output gathered whole, the
    aux loss, its experts' count and their drops (the assignments of the
    batch to its experts past their capacity, from the relocation of the
    gathered ids), and the gradients of ``sum(out * w) + aux`` (each rank's
    rows' part; a leaf's summed over the rows' axes its block does not
    split, then gathered whole) and of the rows."""
    import torch
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models import moe as M
    from repro_torch.sharding import specs
    from repro_torch.train.checkpoint import _map_with_path
    out: Dict[str, Any] = {}
    for name, c in cases.items():
        cfg = MoEConfig(**c["cfg"])
        bspecs = M.plain_block_specs(cfg, mesh)
        spec_of = {}

        def block(key, leaf):
            spec = bspecs.get(key, (None,) * leaf.dim())
            spec_of[key] = spec
            return specs.shard_of(leaf, spec, mesh).requires_grad_()
        pb = _map_with_path(_tree(c["p"]), block)
        x, entry = _rows(mesh, torch.from_numpy(c["x"]))
        x.requires_grad_()
        y, stats = M.moe_apply(pb, x, cfg, mesh=mesh)
        # this rank's experts' drops, from the batch's relocation
        t = x.shape[0] * x.shape[1] * specs.axis_size(mesh, entry)
        e_loc = pb["w_gate"].shape[0]
        e_lo = specs.coordinate(mesh, "model") * e_loc
        ids = specs.gather(M._route(pb, x.detach().reshape(
            -1, x.shape[-1]), cfg)[2], (entry, None), mesh)
        slot_src, _ = M._relocation(ids, M._capacity(t, cfg), e_lo, e_loc)
        assigned = int(((ids >= e_lo) & (ids < e_lo + e_loc)).sum())
        w, _ = _rows(mesh, torch.from_numpy(c["w"]))
        (torch.sum(y * w) + stats["aux_loss"]).backward()
        rows = specs.live_axes(mesh, entry)

        def whole(key, leaf):
            spec = spec_of[key]
            g = specs.all_reduce(leaf.grad, tuple(
                a for a in rows if a not in specs.spec_axes(spec)), mesh)
            return _np(specs.gather(g, spec, mesh))
        out[name] = dict(
            y=_np(specs.gather(y, (entry, None, None), mesh)),
            aux=float(stats["aux_loss"].detach()), experts=e_loc,
            drops=assigned - int((slot_src < t).sum()),
            grads=_map_with_path(pb, whole),
            x_grad=_np(specs.gather(x.grad, (entry, None, None), mesh)))
    out["coords"] = [specs.coordinate(mesh, a) for a in ("data", "model")]
    return out


def plain_part_whole(mesh, cases) -> Dict[str, Any]:
    """Each case on a one-rank mesh: ``moe._plain_part`` with every expert
    (its collectives the identity) and ``moe_apply`` without a mesh, on
    the same whole parameters and rows; both outputs and aux losses."""
    import torch
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models import moe as M
    out: Dict[str, Any] = {}
    for name, c in cases.items():
        cfg = MoEConfig(**c["cfg"])
        p, x = _tree(c["p"]), torch.from_numpy(c["x"])
        with torch.no_grad():
            y, stats = M._plain_part(p, x, cfg, mesh, ())
            want, want_stats = M.moe_apply(p, x, cfg)
        out[name] = dict(y=_np(y), aux=float(stats["aux_loss"]),
                         want=_np(want), want_aux=float(
                             want_stats["aux_loss"]))
    return out


# ---------------------------------------------------------- the mesh step

def _configs(c):
    """The port's model and train config of a step case."""
    from repro_torch.configs import registry
    from repro_torch.launch.dryrun import apply_opt
    from repro_torch.optim import grad_compression as GC
    from repro_torch.optim import optimizers as O
    from repro_torch.train import train_loop as TL
    cfg = dataclasses.replace(registry.get_config(c["arch"] + "-smoke"),
                              dtype="float32")
    if c.get("opt"):
        cfg = apply_opt(cfg)
    if c.get("capacity") is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=c["capacity"]))
    if c.get("act_sp"):
        cfg = dataclasses.replace(cfg, act_sp=True)
    cfg = dataclasses.replace(cfg, **c.get("edit", {}))
    if c.get("dispatch"):
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch=c["dispatch"]))
    tcfg = TL.TrainConfig(
        optimizer=O.AdamWConfig(**c["adamw"]), grad_accum=c["ga"],
        compression=None if c.get("rho") is None
        else GC.CompressionConfig(rho=c["rho"]))
    return cfg, tcfg


def state_from_flat(flat: Dict[str, np.ndarray], cfg, tcfg):
    """A whole port TrainState from checkpoint-keyed numpy leaves."""
    import torch
    from repro_torch.train import train_loop as TL
    from repro_torch.train.checkpoint import _map_with_path
    meta = TL.init_train_state(torch.Generator(), cfg, tcfg, device="meta")
    return _map_with_path(meta, lambda key, leaf: torch.from_numpy(
        np.asarray(flat[key])).to(leaf.dtype).reshape(leaf.shape))


def _metrics(m) -> Dict[str, float]:
    return {k: float(v) for k, v in m.items()}


def _same_tree(a, b) -> bool:
    """Whether two trees hold the same keys and equal tensors (shape,
    dtype and every element)."""
    from repro_torch.train.checkpoint import _map_with_path

    def leaves(tree):
        out = {}
        _map_with_path(tree, lambda key, leaf: out.__setitem__(key, leaf))
        return out
    la, lb = leaves(a), leaves(b)
    return la.keys() == lb.keys() and all(
        la[k].shape == lb[k].shape and la[k].dtype == lb[k].dtype
        and bool((la[k] == lb[k]).all()) for k in la)


def step_suite(mesh, cases) -> Dict[str, Any]:
    """Each case: a config, the reference's initial state (checkpoint keys
    -> numpy) and batches. The mesh step runs from the state's blocks;
    returns each step's metrics, the gathered parameters after the first
    and the last step, the rows' axes of a microbatch, whether
    ``init_train_state(mesh=)`` made the blocks of the whole state the
    same generator makes, and (origin) the port's single-device step's
    metrics and parameters on the same state and batches."""
    import torch
    from repro_torch.sharding import specs
    from repro_torch.train import checkpoint as CK
    from repro_torch.train import train_loop as TL
    out: Dict[str, Any] = {}
    origin = specs.is_origin(mesh)
    for name, c in cases.items():
        cfg, tcfg = _configs(c)
        whole = state_from_flat(c["state"], cfg, tcfg)
        st = TL.state_pspecs(cfg, tcfg, mesh)
        state = specs.shard_tree(whole, st, mesh)
        step = TL.make_train_step(cfg, tcfg, mesh=mesh)
        mb = len(c["batches"][0]["tokens"]) // tcfg.grad_accum
        drawn = TL.init_train_state(torch.Generator().manual_seed(1), cfg,
                                    tcfg, device="cpu", mesh=mesh)
        cut = specs.shard_tree(TL.init_train_state(
            torch.Generator().manual_seed(1), cfg, tcfg, device="cpu"),
            st, mesh)
        res: Dict[str, Any] = dict(
            metrics=[], params=[], init_blocks=_same_tree(drawn, cut),
            row_axes=specs.lm_row_axes(mesh, mb, cfg.batch_over_model))
        del drawn, cut
        for i, batch in enumerate(c["batches"]):
            state, m = step(state, batch)
            res["metrics"].append(_metrics(m))
            if i in (0, len(c["batches"]) - 1):
                g = specs.gather_tree(state, st, mesh)
                if origin:
                    res["params"].append(CK._flatten(g.params))
        if origin:
            single = TL.make_train_step(cfg, tcfg)
            s, res["single_metrics"] = whole, []
            for batch in c["batches"]:
                s, m = single(s, batch)
                res["single_metrics"].append(_metrics(m))
            res["single_params"] = CK._flatten(s.params)
        out[name] = res
    return out


# ------------------------------------------------------------ the launcher

def launcher_suite(mesh, root: str, resume_dir: str) -> Dict[str, Any]:
    """The launcher on every rank (it builds its own mesh over the world),
    each run to ``--steps 4`` with checkpoints every 2 steps:

    * ``a``: internlm2 smoke from scratch; ``a2``: the same failing after
      its second step (its checkpoint at 2 is for one process to resume);
    * ``b0``: internlm2 smoke to ``--steps 2`` on ``resume_dir``, a
      checkpoint at step 2 the single-process launcher wrote: the state
      as restored, before any step; ``b``: the run resumed from it;
    * ``c``: deepseek smoke ``--opt``; ``d``: the same failing after its
      third step, then started again.
    Returns each run's start, losses and (origin) final whole state."""
    from repro_torch.launch import train as launch
    from repro_torch.sharding import specs
    from repro_torch.train import checkpoint as CK
    from repro_torch.train import train_loop as TL

    class Crash(RuntimeError):
        pass

    def crash_at(step):
        def hook(i, state, metrics):
            if i == step:
                raise Crash
        return hook

    def args(arch, ckpt, *extra, steps=4):
        return ["--arch", arch, "--smoke", "--device", "cpu", "--seq-len",
                "32", "--steps", str(steps), "--ckpt-every", "2",
                "--ckpt-dir", ckpt, *extra]

    def result(argv):
        run = launch.main(argv)
        cfg, tcfg, _ = launch.setup(launch.parser().parse_args(argv))
        whole = specs.gather_tree(run["state"], TL.state_pspecs(
            cfg, tcfg, run["mesh"]), run["mesh"])
        return dict(start=run["start"], losses=run["losses"],
                    mesh=tuple(run["mesh"].shape),
                    state=CK._flatten(whole) if specs.is_origin(mesh)
                    else None)

    def failing(argv, step):
        try:
            launch.main(argv, hooks=[crash_at(step)])
        except Crash:
            return CK.latest_step(argv[argv.index("--ckpt-dir") + 1])
        raise AssertionError("the run did not fail")

    intern, deep = "internlm2-1.8b", "deepseek-v2-lite-16b"
    out = {"a": result(args(intern, f"{root}/a")),
           "a2_failed_at": failing(args(intern, f"{root}/a2"), 1),
           "b0": result(args(intern, resume_dir, steps=2)),
           "b": result(args(intern, resume_dir)),
           "c": result(args(deep, f"{root}/c", "--opt")),
           "d_failed_at": failing(args(deep, f"{root}/d", "--opt"), 2)}
    out["d"] = result(args(deep, f"{root}/d", "--opt"))
    return out


def ep_rows_refusal(mesh, case) -> Any:
    """``moe_apply_ep`` given rows replicated over the data axis
    (``batch_axes=()``): the ``ValueError``'s message, or None where it
    ran (a data axis of one rank)."""
    import torch
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models import moe as M
    from repro_torch.sharding import specs
    from repro_torch.train.checkpoint import _map_with_path
    cfg = MoEConfig(**case["cfg"])
    bspecs = M.ep_block_specs(cfg, mesh, False)
    p = _map_with_path(_tree(case["p"]), lambda key, leaf: specs.shard_of(
        leaf, bspecs.get(key, (None,) * leaf.dim()), mesh))
    try:
        M.moe_apply_ep(p, torch.from_numpy(case["x"]), cfg, mesh=mesh,
                       batch_axes=())
    except ValueError as e:
        return str(e)
    return None


def mesh_suite(mesh, ep_cases, step_cases) -> Dict[str, Any]:
    """:func:`ep_suite`, :func:`ep_rows_refusal` and :func:`step_suite` in
    one spawn."""
    return dict(ep=ep_suite(mesh, ep_cases),
                ep_rows_refused=ep_rows_refusal(mesh, ep_cases["cap8"]),
                steps=step_suite(mesh, step_cases))


# ------------------------------------------------ tensor and sequence parallel

def _module_cfg(c):
    """The port's float32 smoke config of a TP module case, with its
    edits (``n_kv_heads``, ``n_heads``)."""
    from repro_torch.configs import registry
    cfg = dataclasses.replace(registry.get_config(c["arch"] + "-smoke"),
                              dtype="float32")
    return dataclasses.replace(cfg, **c.get("edit", {}))


def _seq_block(tp, x):
    """This rank's block of ``x``'s sequence (dim 1)."""
    from repro_torch.sharding import specs
    return x[:, specs.block_slice(tp.mesh, x.shape[1], "model")]


def tp_modules(mesh, cases) -> Dict[str, Any]:
    """Each case runs one module the way ``forward(..., mesh=)`` runs it
    (``transformer._mixer`` with the plan's split leaves): its weights this
    rank's blocks under :func:`repro_torch.models.transformer.tp_plan`,
    the input whole (``seq``: the rank's sequence block, under sequence
    parallelism). Returns (origin) each output whole, and whether the
    plan split the module."""
    import torch
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as S
    from repro_torch.models import transformer as T
    from repro_torch.sharding import specs
    out: Dict[str, Any] = {}
    for name, c in cases.items():
        cfg = _module_cfg(c)
        tp = T._tp_of(cfg, mesh, ())
        plan = T.tp_plan(cfg, mesh)
        if tp is not None and c.get("seq"):
            tp = tp._replace(seq=True)
        p = _tree(c["p"])
        x = torch.from_numpy(c["x"])
        kind = c["kind"]
        if kind in ("embed", "head", "ce"):
            table = "embed" if kind == "embed" else "lm_head"
            w = specs.shard_of(p["w"], plan[table], mesh)
            split = tp is not None and T._keeps(plan[table])
            part = tp if split else None
            if kind == "embed":
                y = L.embed_lookup(w, x, part)
            elif kind == "head":
                y = x @ w if part is None else specs.gather_along(
                    part.enter(x) @ w, 2, "model", mesh, summed=False)
            else:
                v = specs.block_slice(mesh, x.shape[-1], plan[table][1]) \
                    if split else slice(None)
                y = L.cross_entropy(x[..., v], torch.from_numpy(c["labels"]),
                                    torch.from_numpy(c["mask"]), tp=part)
            out[name] = dict(y=_np(y), split=split)
            continue
        mod = {"mlp": "mlp", "gqa": "attn", "xattn": "attn", "mla": "attn",
               "ssm": "ssm"}[kind]
        lplan = T._layer_plan(plan["layers"])
        blocks = {k: specs.shard_of(v, lplan[mod][k], mesh)
                  for k, v in p.items()}
        split = T._blocks(tp, lplan)(mod)
        kv = None if c.get("kv") is None else torch.from_numpy(c["kv"])
        fns = {
            "mlp": lambda h, t: L.mlp_apply(blocks, h, t),
            "gqa": lambda h, t: A.gqa_apply(blocks, h, cfg, tp=t)[0],
            "xattn": lambda h, t: A.gqa_apply(
                blocks, h, cfg, kv_input=kv, causal=False, tp=t)[0],
            "mla": lambda h, t: A.mla_apply(blocks, h, cfg, tp=t)[0],
            "ssm": lambda h, t: S.ssm_apply(blocks, h, cfg, tp=t)[0],
        }
        h = x if tp is None or not tp.seq else _seq_block(tp, x)
        y = T._mixer(fns[kind], h, tp, split)
        if tp is not None and tp.seq:
            y = specs.gather(y, (None, "model"), mesh)
        out[name] = dict(y=_np(y), split=bool(split))
    return out if specs.is_origin(mesh) else {}


def tp_grads(mesh, cases) -> Dict[str, Any]:
    """Each case: a config, the reference's initial state (checkpoint
    keys -> numpy), a batch and the reference's single-device gradient
    (parameter keys -> numpy). Every rank takes the mesh step's gradients
    without compression (``train_loop._mesh_grads``, cut to the state's
    blocks as the step cuts them) and compares each leaf's block with its
    block of the reference's: returns, per rank, each leaf's largest
    |difference| over the whole leaf's largest |value|, and the shape
    of each block."""
    import torch
    from repro_torch.sharding import specs
    from repro_torch.train import train_loop as TL
    from repro_torch.train.checkpoint import _map_with_path
    out: Dict[str, Any] = {}
    for name, c in cases.items():
        cfg, tcfg = _configs(c)
        whole = state_from_flat(c["state"], cfg, tcfg)
        st = TL.state_pspecs(cfg, tcfg, mesh)
        blocks = specs.shard_tree(whole, st, mesh)
        grads_fn, _, fetch = TL._mesh_grads(cfg, tcfg, mesh)
        _, _, grads = grads_fn(blocks.params, c["batch"])
        grads = TL.tree_map(lambda g, f: TL._cut(g, f, mesh), grads, fetch)
        spec_of = specs._spec_table(st.params)
        flat = {}
        _map_with_path(grads, lambda key, g: flat.__setitem__(key, g))
        res = {}
        for key, g in flat.items():
            want = torch.from_numpy(c["grad"][key]).to(g.dtype)
            scale = float(want.abs().max())
            err = float((g - specs.shard_of(want, spec_of[key], mesh))
                        .abs().max())
            res[key] = (err / scale if scale else err, tuple(g.shape))
        out[name] = res
    return out


def tp_layout(mesh, cases) -> Dict[str, Any]:
    """Each case: a config (``act_sp`` or not) and a batch, the state
    drawn by ``init_train_state(mesh=)``. (1) One mesh step without
    compression and one with, the leaves gathered outside the
    activations' collectives recorded: the state's parameter blocks the
    step gathers (by key) and any other gather of a float tensor (a
    gradient's). (2) The
    forward's residual stream: the sequence length of every block's
    input."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.sharding import specs
    from repro_torch.train import train_loop as TL
    from repro_torch.train.checkpoint import _map_with_path
    out: Dict[str, Any] = {}
    gather, along, block = specs.gather, specs._along, T._block_apply
    inside = [0]
    record: Dict[str, Any] = {}

    def spy_gather(x, spec, mesh_):
        # the plain MoE layer's int32 expert ids are an activation's
        if not inside[0] and x.is_floating_point() \
                and any(specs.split(mesh_, e) for e in spec):
            key = record["ids"].get(id(x))
            record["params" if key else "other"].append(key or tuple(
                x.shape))
        return gather(x, spec, mesh_)

    def spy_along(*args):
        inside[0] += 1
        try:
            return along(*args)
        finally:
            inside[0] -= 1

    def spy_block(p, x, *args, **kw):
        record["seq"].append(int(x.shape[1]))
        return block(p, x, *args, **kw)

    specs.gather, specs._along, T._block_apply = spy_gather, spy_along, \
        spy_block
    try:
        for name, c in cases.items():
            res = {}
            for rho in (None, 0.1):
                cfg, tcfg = _configs(dict(c, rho=rho))
                state = TL.init_train_state(
                    torch.Generator().manual_seed(0), cfg, tcfg,
                    device="cpu", mesh=mesh)
                ids = {}
                _map_with_path(state.params,
                               lambda key, leaf: ids.__setitem__(id(leaf),
                                                                 key))
                record.update(ids=ids, params=[], other=[], seq=[])
                TL.make_train_step(cfg, tcfg, mesh=mesh)(state, c["batch"])
                res["compress" if rho else "plain"] = dict(
                    params=sorted(set(record["params"])),
                    other=len(record["other"]), seq=list(record["seq"]))
            out[name] = res
    finally:
        specs.gather, specs._along, T._block_apply = gather, along, block
    return out


def tp_suite(mesh, module_cases, grad_cases, layout_cases) -> Dict[str, Any]:
    """:func:`tp_modules`, :func:`tp_grads` and :func:`tp_layout` in one
    spawn."""
    import torch
    torch.manual_seed(0)
    return dict(modules=tp_modules(mesh, module_cases),
                grads=tp_grads(mesh, grad_cases),
                layout=tp_layout(mesh, layout_cases))


# ------------------------------------------------------- decode on a mesh

def _state_key(key: str) -> str:
    """A serve-state leaf's key without the NamedTuple dots
    (``".layer_caches/.k"`` -> ``"layer_caches/k"``)."""
    return "/".join(seg.lstrip(".") for seg in key.split("/"))


def decode_suite(mesh, cases, pods=None) -> Dict[str, Any]:
    """Each case: the reference's whole parameters, its prefilled serve
    state and its state after the steps (flat, by :func:`_state_key`), the
    tokens of each step and, for audio, the frames and the encoder output.
    The rank takes its blocks of the parameters (``serve_pspecs``) and of
    the prefilled state (``serve_shardings``; their shapes must be those
    of ``init_serve_state(mesh=)``'s blocks), decodes with
    ``decode_step(mesh=)`` and returns the whole logits of every step and,
    per state leaf, the largest difference of its final block from its
    block of the reference's final state, beside that leaf's largest
    |value|. ``pods``: decode on a ``("pod", "data", "model")`` mesh of
    that shape over the same ranks instead."""
    import torch
    from repro_torch import convert
    from repro_torch.launch.mesh import fake_mesh
    from repro_torch.models import transformer as T
    from repro_torch.sharding import specs
    from repro_torch.train.checkpoint import _map_with_path
    if pods is not None:
        mesh = fake_mesh(tuple(pods), ("pod", "data", "model"))
    out: Dict[str, Any] = {}
    for name, c in cases.items():
        cfg = _decode_cfg(c)
        params = convert.lm_params_from_numpy(c["p"], cfg, device="cpu")
        blocks = specs.shard_tree(params, T.serve_pspecs(cfg, mesh), mesh)
        frames = None if c.get("frames") is None \
            else torch.from_numpy(c["frames"])
        b, n = c["tokens"].shape
        blank = T.init_serve_state(blocks, cfg, b, c["max_len"],
                                   frames=frames, mesh=mesh)
        res: Dict[str, Any] = {}

        def block(key, arr, like=None):
            arr = np.asarray(arr)
            spec = specs.cache_pspec(key, arr, mesh)
            t = specs.shard_of(torch.from_numpy(arr), spec, mesh)
            if like is not None:
                if tuple(t.shape) != tuple(like.shape):
                    raise AssertionError(f"{name} {key}: block "
                                         f"{tuple(like.shape)}, expected "
                                         f"{tuple(t.shape)}")
                t = t.to(like.dtype)
            return t
        if frames is not None:
            want = block(".enc_out", c["enc_out"])
            res["enc_err"] = (float((blank.enc_out - want).abs().max()),
                              float(np.abs(c["enc_out"]).max()))
        state = _map_with_path(blank, lambda key, leaf: block(
            key, c["state"][_state_key(key)], leaf))
        logits = []
        for t in range(n):
            lg, state = T.decode_step(blocks, cfg, state,
                                      torch.from_numpy(c["tokens"][:, t:t + 1]),
                                      mesh=mesh)
            logits.append(_np(lg))
        errs = {}

        def err(key, leaf):
            want = c["final"][_state_key(key)]
            got = leaf.float() - block(key, want).float()
            errs[_state_key(key)] = (float(got.abs().max()) if got.numel()
                                     else 0.0,
                                     float(np.abs(np.asarray(
                                         want, dtype=np.float64)).max()))
        _map_with_path(state, err)
        res.update(logits=logits, state_err=errs)
        out[name] = res
    return out


def _decode_cfg(c):
    """The port's float32 smoke config of a decode case: ``--opt`` and
    a drop-free capacity where the case asks for them, and its edits."""
    from repro_torch.configs import registry
    from repro_torch.launch.dryrun import apply_opt
    cfg = dataclasses.replace(registry.get_config(c["arch"] + "-smoke"),
                              dtype="float32", **c.get("edit", {}))
    if c.get("opt"):
        cfg = apply_opt(cfg)
    if c.get("capacity") is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=c["capacity"]))
    return cfg


# ------------------------------------------------------------ the dry run

def dryrun_suite(mesh, cases) -> Dict[str, Any]:
    """Each case: a float32 smoke config (:func:`_decode_cfg`) and a
    shape; the
    rank's step of the cell (``dryrun.build_step``) run once on real CPU
    tensors under ``op_cost.OpCost`` (``dryrun.trace_cell(fake=False)``):
    its argument bytes, FLOPs and collectives, and the rank's
    coordinates."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun as D
    from repro_torch.sharding import specs
    out: Dict[str, Any] = {}
    for name, c in cases.items():
        cfg = _decode_cfg(c)
        got = D.trace_cell(cfg, ShapeConfig(**c["shape"]), mesh,
                           c.get("opt", False), fake=False)
        out[name] = dict(argument_bytes=got["memory"]["argument_bytes"],
                         state_bytes=got["state_bytes"], flops=got["flops"],
                         collectives=got["collectives"])
    out["coords"] = [specs.coordinate(mesh, a) for a in ("data", "model")]
    # the meshes of launch.mesh over this real group of four ranks
    from repro_torch.launch import mesh as M
    dev = M.make_dev_mesh(mesh.shape[0], mesh.shape[1])
    same = M.fake_mesh(tuple(mesh.shape), ("data", "model"))
    out["meshes"] = [(tuple(m.shape), tuple(m.mesh_dim_names),
                      m.device_type) for m in (dev, same)]
    try:
        M.make_production_mesh()
    except ValueError as e:
        out["refused"] = str(e)
    return out


# ---------------------------------------------------------------- donation

def _leaves(tree) -> Dict[str, Any]:
    """A tree's tensors by checkpoint key."""
    import torch
    from repro_torch.train.checkpoint import _map_with_path
    out: Dict[str, Any] = {}
    _map_with_path(tree, lambda key, leaf: out.__setitem__(key, leaf)
                   if isinstance(leaf, torch.Tensor) else None)
    return out


def _copy(tree):
    import torch
    from repro_torch.train.checkpoint import _map_with_path
    return _map_with_path(tree, lambda key, leaf: leaf.clone()
                          if isinstance(leaf, torch.Tensor) else leaf)


def _bits(t):
    """A tensor's bytes, so -0.0 and 0.0 (and NaNs) compare as stored."""
    import torch
    return t.detach().reshape(-1).contiguous().view(torch.uint8)


def _same_bits(a, b) -> bool:
    import torch
    return a.dtype == b.dtype and a.shape == b.shape \
        and torch.equal(_bits(a), _bits(b))


def _donation(run, state, n: int) -> Dict[str, Any]:
    """``run(state, t, donate) -> (outputs, new state)`` ``n`` times from
    two copies of ``state``, functional and donated: the step and leaf
    keys whose outputs or final values are not bit for bit the same, and
    the leaves whose storage the donated steps did not keep."""
    a, b = _copy(state), _copy(state)
    ptrs = {k: v.data_ptr() for k, v in _leaves(b).items()}
    differ = []
    for t in range(n):
        oa, a = run(a, t, False)
        ob, b = run(b, t, True)
        differ += [f"step {t}: {k}" for k in oa
                   if not _same_bits(oa[k], ob[k])]
    la, lb = _leaves(a), _leaves(b)
    differ += [k for k in la if k not in lb or not _same_bits(la[k], lb[k])]
    return dict(differ=differ, moved=sorted(
        k for k in ptrs if k not in lb or lb[k].data_ptr() != ptrs[k]),
        leaves=len(lb))


def donated_train(cfg, tcfg, state, batches, mesh=None) -> Dict[str, Any]:
    """:func:`_donation` of ``make_train_step(cfg, tcfg, mesh=)`` over
    ``batches`` (its metrics compared too)."""
    from repro_torch.train import train_loop as TL
    steps = {d: TL.make_train_step(cfg, tcfg, mesh=mesh, donate=d)
             for d in (False, True)}
    def run(st, t, donate):
        st, metrics = steps[donate](st, batches[t])
        return metrics, st
    return _donation(run, state, len(batches))


def donated_decode(params, cfg, state, tokens, mesh=None) -> Dict[str, Any]:
    """:func:`_donation` of ``decode_step(..., mesh=)`` on ``tokens`` (n,
    B, 1) (its logits compared too)."""
    import torch
    from repro_torch.models import transformer as T

    def run(st, t, donate):
        with torch.no_grad():
            logits, st = T.decode_step(params, cfg, st, tokens[t],
                                       mesh=mesh, donate=donate)
        return {"logits": logits}, st
    return _donation(run, state, len(tokens))


def random_serve_state(params, cfg, batch: int, max_len: int, pos: int,
                       seed: int, frames=None):
    """A whole serve state of ``cfg`` with caches of normal draws from
    ``seed`` (the audio encoder output too) and every position at
    ``pos``."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.train.checkpoint import _map_with_path
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        whole = T.init_serve_state(params, cfg, batch, max_len,
                                   frames=frames)

    def fill(key, leaf):
        if leaf.dtype.is_floating_point:
            return torch.randn(leaf.shape, generator=gen).to(leaf.dtype)
        return torch.full_like(leaf, pos)
    return _map_with_path(whole, fill)


def donate_suite(mesh, cases) -> Dict[str, Any]:
    """Each case a train case (:func:`_configs`' keys, and ``seq``, the
    batch's ``rows`` and ``steps``) or a decode case (``decode``: True,
    :func:`_decode_cfg`'s keys, and ``batch``, ``max_len``, ``pos``,
    ``steps``). A train case: the state made as blocks
    (``init_train_state(mesh=)``, seed 0) and batches drawn from a numpy
    seed, through :func:`donated_train`; a decode case: the rank's blocks
    of whole parameters (seed 0, ``serve_pspecs``) and of a whole
    :func:`random_serve_state` (``serve_shardings``), through
    :func:`donated_decode`. Returns each case's result."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.sharding import specs
    from repro_torch.train import train_loop as TL
    from repro_torch.train.checkpoint import _map_with_path
    out: Dict[str, Any] = {}
    for name, c in cases.items():
        rng = np.random.default_rng(7)
        if not c.get("decode"):
            cfg, tcfg = _configs(c)
            state = TL.init_train_state(torch.Generator().manual_seed(0),
                                        cfg, tcfg, device="cpu", mesh=mesh)
            batches = [{k: rng.integers(0, cfg.vocab_size,
                                        (c["rows"], c["seq"]))
                        for k in ("tokens", "labels")}
                       for _ in range(c["steps"])]
            out[name] = donated_train(cfg, tcfg, state, batches, mesh)
            continue
        cfg = _decode_cfg(c)
        params = T.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
        blocks = specs.shard_tree(params, T.serve_pspecs(cfg, mesh), mesh)
        b = c["batch"]
        frames = None if cfg.family != "audio" else torch.from_numpy(
            rng.standard_normal((b, cfg.encdec.encoder_seq,
                                 cfg.frontend.d_embed)).astype(np.float32))
        whole = random_serve_state(params, cfg, b, c["max_len"], c["pos"],
                                   1, frames)
        state = _map_with_path(whole, lambda key, leaf: specs.shard_of(
            leaf, specs.cache_pspec(key, leaf, mesh), mesh))
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                               (c["steps"], b, 1)))
        out[name] = donated_decode(blocks, cfg, state, tokens, mesh)
    return out
