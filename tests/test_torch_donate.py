"""Donated state: ``make_train_step(..., donate=True)`` and
``decode_step(..., donate=True)``, the port's counterpart of the
reference's ``donate_argnums`` (its launcher's and dry run's jitted
steps), on the CPU.

* A donated step equals the functional step bit for bit and keeps the
  storage of every state leaf. Train: dense, moe (GQA with a dense
  residual, and MLA), ssm and hybrid smoke configs, ``grad_accum`` 1 and
  4 with top-k compression, 2 steps: parameters, AdamW moments, error
  feedback, both step counters and every metric (AdamW's update a piece
  of a few rows at a time, and at its default piece size). Decode: the
  six families (hybrid with one KV cache per shared site), scalar
  positions and per-slot ones with a row whose writes run past the cache
  (dropped), 4 steps: every step's logits and every cache leaf.
* The same on four gloo ranks (``tests/_torch_lm_dist.py:
  donate_suite``), on a ``(2, 2)`` mesh: the mesh train step with
  compression (the error buffer gathered whole, the rank's blocks written
  back) and with the expert-parallel MoE layer, and the mesh decode of
  every family (zamba2's site caches split over ``data``: a site's owner
  writes it).
* The dry run traces arctic-480b ``decode_32k`` on ``(16, 16)``, with
  and without ``--opt``, to a rank's peak of at most 80 GB (an H100's
  memory), with its argument bytes equal to the reference's per-device
  shard bytes of the cell's parameters, serve state and tokens.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_dist as TD  # noqa: E402
import _torch_lm_dist as LD  # noqa: E402
import test_torch_dryrun_bytes as DB  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import grad_compression as GC  # noqa: E402
from repro_torch.optim import optimizers as O  # noqa: E402
from repro_torch.train import train_loop as TL  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]

TRAIN_ARCHS = {"dense": "internlm2-1.8b", "moe": "arctic-480b",
               "mla": "deepseek-v2-lite-16b", "ssm": "mamba2-780m",
               "hybrid": "zamba2-1.2b"}
#: (grad_accum, compression's kept fraction or None)
TRAIN_MODES = {"ga1": (1, None), "ga4_compress": (4, 0.05)}
#: rows a piece of AdamW's update: the smoke leaves' pieces
SMALL_CHUNK = 256
DECODE_ARCHS = {"dense": "internlm2-1.8b", "vlm": "phi-3-vision-4.2b",
                "audio": "seamless-m4t-medium", "moe": "arctic-480b",
                "mla": "deepseek-v2-lite-16b", "ssm": "mamba2-780m",
                "hybrid": "zamba2-1.2b"}
#: the families whose serve state takes per-slot positions
PER_SLOT = ("dense", "vlm", "moe", "mla")
B, MAX_LEN, STEPS = 3, 8, 4
#: per-slot positions: the last row writes past the cache's end at its
#: third step
SLOT_POS = (0, 2, 6)
CARD_BYTES = 80e9


def _train_case(arch: str, ga: int, rho):
    cfg = registry.get_config(arch + "-smoke")
    tcfg = TL.TrainConfig(
        optimizer=O.AdamWConfig(lr=1e-2, warmup_steps=1),
        grad_accum=ga,
        compression=None if rho is None else GC.CompressionConfig(rho=rho))
    state = TL.init_train_state(torch.Generator().manual_seed(0), cfg, tcfg,
                                "cpu")
    rng = np.random.default_rng(3)
    batches = [{k: rng.integers(0, cfg.vocab_size, (4, 16))
                for k in ("tokens", "labels")} for _ in range(2)]
    return cfg, tcfg, state, batches


@pytest.fixture(scope="module")
def train_results():
    out = {}
    for fam, arch in TRAIN_ARCHS.items():
        for mode, (ga, rho) in TRAIN_MODES.items():
            cfg, tcfg, state, batches = _train_case(arch, ga, rho)
            old = O.UPDATE_CHUNK
            O.UPDATE_CHUNK = SMALL_CHUNK
            try:
                out[fam, mode] = LD.donated_train(cfg, tcfg, state, batches)
            finally:
                O.UPDATE_CHUNK = old
    cfg, tcfg, state, batches = _train_case(TRAIN_ARCHS["dense"], 1, None)
    out["dense", "default_chunk"] = LD.donated_train(cfg, tcfg, state,
                                                     batches)
    return out


TRAIN_CASES = [(f, m) for f in TRAIN_ARCHS for m in TRAIN_MODES] \
    + [("dense", "default_chunk")]


@pytest.mark.parametrize("fam,mode", TRAIN_CASES)
def test_donated_train_step_equals_the_functional_step(train_results, fam,
                                                       mode):
    got = train_results[fam, mode]
    assert got["differ"] == []


@pytest.mark.parametrize("fam,mode", TRAIN_CASES)
def test_donated_train_step_keeps_every_leaf(train_results, fam, mode):
    got = train_results[fam, mode]
    # parameters, m, v, the AdamW step and the state's step (and the
    # error buffer when compressing)
    assert got["leaves"] > 10
    assert got["moved"] == []


def test_small_pieces_split_the_embedding():
    """At the small piece size AdamW updates the smoke embedding in
    several pieces of rows (the donated pieces are written back one by
    one)."""
    cfg = registry.get_config("internlm2-1.8b-smoke")
    rows = max(1, SMALL_CHUNK // cfg.d_model)
    assert rows < cfg.vocab_size


def _decode_case(fam: str, per_slot: bool):
    cfg = registry.get_config(DECODE_ARCHS[fam] + "-smoke")
    params = T.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    rng = np.random.default_rng(5)
    frames = None if cfg.family != "audio" else torch.from_numpy(
        rng.standard_normal((B, cfg.encdec.encoder_seq,
                             cfg.frontend.d_embed)).astype(np.float32))
    state = LD.random_serve_state(params, cfg, B, MAX_LEN, 2, 1, frames)
    if per_slot:
        state = T.per_slot_state(state, B)
        pos = torch.tensor(SLOT_POS, dtype=torch.int32)
        state = state._replace(
            layer_caches=state.layer_caches._replace(
                pos=pos.expand(cfg.n_layers, B).clone()), pos=pos)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (STEPS, B, 1)))
    return params, cfg, state, tokens


DECODE_CASES = [(f, "scalar") for f in DECODE_ARCHS] \
    + [(f, "per_slot") for f in PER_SLOT]


@pytest.fixture(scope="module")
def decode_results():
    return {(f, pos): LD.donated_decode(*_decode_case(f, pos == "per_slot"))
            for f, pos in DECODE_CASES}


@pytest.mark.parametrize("fam,pos", DECODE_CASES)
def test_donated_decode_equals_the_functional_step(decode_results, fam, pos):
    assert decode_results[fam, pos]["differ"] == []


@pytest.mark.parametrize("fam,pos", DECODE_CASES)
def test_donated_decode_keeps_every_leaf(decode_results, fam, pos):
    got = decode_results[fam, pos]
    # K, V and positions, or the conv window, SSD state and position
    assert got["leaves"] >= 3
    assert got["moved"] == []


def test_hybrid_smoke_has_shared_sites():
    """The hybrid case writes site caches: a site after every layer."""
    cfg = registry.get_config("zamba2-1.2b-smoke")
    assert [T._shared_site(cfg, i) for i in range(cfg.n_layers)] == [0, 1]


def test_per_slot_writes_past_the_cache_are_dropped():
    """The donated per-slot write drops the positions past the cache, as
    the functional one's trash row does, and leaves the rest of the row
    as it was."""
    from repro_torch.models import attention as A
    buf = torch.arange(2 * 4, dtype=torch.float32).reshape(2, 4, 1)
    new = -torch.ones(2, 3, 1)
    pos = torch.tensor([0, 3], dtype=torch.int32)
    want = A._cache_update(buf, new, pos)
    got = A._cache_update(buf.clone(), new, pos, donate=True)
    assert torch.equal(got, want)
    assert want[1, :, 0].tolist() == [4.0, 5.0, 6.0, -1.0]


# ------------------------------------------------------------ gloo mesh

MESH = (2, 2)
_ADAMW = dict(lr=1e-2, warmup_steps=1)
MESH_CASES = {
    "train_dense_compress": dict(arch="internlm2-1.8b", ga=2, rho=0.05,
                                 adamw=_ADAMW, rows=4, seq=8, steps=2),
    "train_moe_opt": dict(arch="deepseek-v2-lite-16b", opt=True, ga=1,
                          adamw=_ADAMW, rows=4, seq=8, steps=2),
    "train_ssm": dict(arch="mamba2-780m", ga=1, adamw=_ADAMW, rows=4,
                      seq=8, steps=2),
    **{f"decode_{fam}": dict(decode=True, arch=arch, batch=4, max_len=8,
                             pos=2, steps=STEPS)
       for fam, arch in DECODE_ARCHS.items()},
}


@pytest.fixture(scope="module")
def mesh_results(tmp_path_factory):
    ranks = TD.run("_torch_lm_dist:donate_suite", MESH, args=(MESH_CASES,),
                   tmp_dir=tmp_path_factory.mktemp("donate"), kind="lm")
    return ranks


@pytest.mark.parametrize("name", list(MESH_CASES))
def test_mesh_donated_step_equals_the_functional_step(mesh_results, name):
    for rank in mesh_results:
        assert rank[name]["differ"] == []


@pytest.mark.parametrize("name", list(MESH_CASES))
def test_mesh_donated_step_keeps_every_block(mesh_results, name):
    for rank in mesh_results:
        assert rank[name]["leaves"] >= 3
        assert rank[name]["moved"] == []


# ------------------------------------------------------------- dry run

#: arctic-480b decode_32k on (16, 16), with and without --opt
ARCTIC = {"arctic_decode": False, "arctic_decode_opt": True}

_PORT = r"""
import json, sys
from repro_torch.launch import dryrun as D
opt = json.loads(sys.argv[1])
rec = D.run_cell("arctic-480b", "decode_32k", False, opt=opt)
print(json.dumps(dict(status=rec["status"], peak=rec.get("peak_bytes"),
                      memory=rec.get("memory"), error=rec.get("error"))))
"""


@pytest.fixture(scope="module")
def arctic():
    """Each cell traced in a subprocess of its own, beside the
    reference's argument bytes of both (one subprocess), all at once."""
    pytest.importorskip("jax")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", _PORT, json.dumps(opt)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT) for name, opt in ARCTIC.items()}
    procs["reference"] = DB._run(DB._REFERENCE, env, {
        name: ("arctic-480b", "decode_32k", opt, False, False)
        for name, opt in ARCTIC.items()})
    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=900)
        assert proc.returncode == 0, f"{name}: {stderr[-3000:]}"
        out[name] = json.loads(stdout.strip().splitlines()[-1])
    return out


@pytest.mark.parametrize("name", list(ARCTIC))
def test_arctic_decode_fits_the_card_with_donated_state(arctic, name):
    got = arctic[name]
    assert got["status"] == "ok", got["error"]
    assert 0 < got["peak"] <= CARD_BYTES
    mem = got["memory"]
    assert mem["argument_bytes"] == arctic["reference"][name]["argument"]
    # the new caches are the argument's: the outputs beyond them are the
    # logits alone
    assert 0 < mem["output_bytes"] - mem["alias_bytes"] < 1e9
    assert got["peak"] >= mem["argument_bytes"] + mem["temp_bytes"]
