"""The dry run's per-rank bytes against the reference's layout: the port's
``memory.argument_bytes`` (the state's blocks and the rank's block of the
batch) and the bytes of its state's blocks equal, byte for byte, the sums
of the reference's per-device shard shapes under ``param_shardings`` /
``serve_shardings`` / ``data_shardings`` on ``jax.eval_shape`` trees,
over the reference's production mesh of 256 or 512 host devices (no
compile), for internlm2-1.8b ``train_4k``, deepseek-v2-lite-16b
``train_4k --opt`` and mamba2-780m ``decode_32k`` on ``(16, 16)``, and
for arctic-480b ``train_4k --opt`` on ``(2, 16, 16)`` the train state
alone (its blocks made under ``FakeTensorMode``, no step). Both sides run
in subprocesses, side by side: the reference's dry run sets
``XLA_FLAGS`` for its process, and the port's fake process group is its
process's own.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: (arch, shape, --opt, multi-pod, state only)
CELLS = {
    "internlm2_train": ("internlm2-1.8b", "train_4k", False, False, False),
    "deepseek_opt_train": ("deepseek-v2-lite-16b", "train_4k", True, False,
                           False),
    "mamba2_decode": ("mamba2-780m", "decode_32k", False, False, False),
    "arctic_opt_train_2pod": ("arctic-480b", "train_4k", True, True, True),
}

_REFERENCE = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding
from repro.launch import dryrun as RD      # 512 host devices
from repro.configs.base import SHAPES_BY_NAME
from repro.configs.registry import get_config
from repro.launch.input_specs import input_specs
from repro.models import transformer as T
from repro.optim.optimizers import AdamWConfig
from repro.sharding import specs as SH
from repro.train import train_loop as TL


def nbytes(tree, shardings):
    leaves = jax.tree.leaves(tree)
    shs = jax.tree.leaves(shardings,
                          is_leaf=lambda x: isinstance(x, NamedSharding))
    assert len(leaves) == len(shs)
    return int(sum(int(np.prod(sh.shard_shape(l.shape))) * l.dtype.itemsize
                   for l, sh in zip(leaves, shs)))


out = {}
for name, (arch, shape_name, opt, pod, state_only) in json.loads(
        sys.argv[1]).items():
    cfg = get_config(arch)
    if opt:
        cfg = RD.apply_opt(cfg)
    shape = SHAPES_BY_NAME[shape_name]
    mesh = RD.make_production_mesh(multi_pod=pod)
    batch = input_specs(cfg, shape)
    if shape.kind == "train":
        big = cfg.param_count() > 100e9
        tcfg = TL.TrainConfig(
            grad_accum=8 if (big and not opt) else 1,
            optimizer=AdamWConfig(
                moments_dtype="bfloat16" if big else "float32"))
        st = jax.eval_shape(
            lambda: TL.init_train_state(jax.random.PRNGKey(0), cfg, tcfg))
        state = nbytes(st, SH.param_shardings(
            st, mesh, replicate_embed=cfg.batch_over_model))
        data = nbytes(batch, SH.data_shardings(
            mesh, batch, over_model=cfg.batch_over_model))
        out[name] = dict(state=state, argument=state + data)
    elif shape.kind == "prefill":
        ps = jax.eval_shape(lambda: T.init_params(jax.random.PRNGKey(0), cfg))
        state = nbytes(ps, SH.param_shardings(ps, mesh))
        out[name] = dict(state=state, argument=state + nbytes(
            batch, SH.data_shardings(mesh, batch,
                                     over_model=cfg.batch_over_model)))
    else:
        ps = jax.eval_shape(lambda: T.init_params(jax.random.PRNGKey(0), cfg))
        b = shape.global_batch
        ss = jax.eval_shape(
            lambda p: T.init_serve_state(p, cfg, b, shape.seq_len), ps)
        state = nbytes(ss, SH.serve_shardings(ss, mesh))
        toks = {"tokens": jax.ShapeDtypeStruct((b, 1), jnp.int32)}
        out[name] = dict(state=state, argument=state + nbytes(
            ps, SH.param_shardings(ps, mesh)) + nbytes(
            toks, SH.data_shardings(mesh, toks)))
print(json.dumps(out))
"""

_PORT = r"""
import json, sys
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.configs.base import SHAPES_BY_NAME
from repro_torch.configs.registry import get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.roofline.op_cost import tensor_bytes
from repro_torch.train import train_loop as TL
out = {}
for name, (arch, shape_name, opt, pod, state_only) in json.loads(
        sys.argv[1]).items():
    cfg = get_config(arch)
    if opt:
        cfg = D.apply_opt(cfg)
    shape = SHAPES_BY_NAME[shape_name]
    mesh = make_production_mesh(multi_pod=pod)
    if state_only:
        with FakeTensorMode():
            st = TL.init_train_state(torch.Generator(), cfg,
                                     D.train_config(cfg, opt), "cpu",
                                     mesh=mesh)
            out[name] = dict(state=tensor_bytes(st))
        continue
    got = D.trace_cell(cfg, shape, mesh, opt)
    out[name] = dict(state=got["state_bytes"],
                     argument=got["memory"]["argument_bytes"])
print(json.dumps(out))
"""


def _run(code, env, cells=CELLS):
    """``code`` on ``cells`` in a subprocess (the reference's side is
    :data:`_REFERENCE`, which takes train, prefill and decode cells)."""
    return subprocess.Popen([sys.executable, "-c", code, json.dumps(cells)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=ROOT)


@pytest.fixture(scope="module")
def both():
    pytest.importorskip("jax")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    procs = {"reference": _run(_REFERENCE, env), "port": _run(_PORT, env)}
    out = {}
    for side, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=900)
        assert proc.returncode == 0, f"{side}: {stderr[-3000:]}"
        out[side] = json.loads(stdout.strip().splitlines()[-1])
    return out


@pytest.mark.parametrize("name", list(CELLS))
def test_per_rank_bytes_equal_the_reference(both, name):
    want, got = both["reference"][name], both["port"][name]
    assert got["state"] == want["state"] > 0
    if not CELLS[name][4]:
        assert got["argument"] == want["argument"]
