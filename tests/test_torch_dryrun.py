"""The port's dry run (``repro_torch.launch.dryrun``, ``input_specs``,
``mesh``, ``roofline/``) against the reference's, on the CPU.

* ``input_specs`` and ``cell_is_applicable`` give the reference's keys,
  shapes and dtypes for every architecture x shape (the port's stand-ins
  are ``meta`` tensors); ``model_flops`` equals the reference's for every
  cell, and ``compute_terms`` the reference's with the reference's
  constants patched into the port's module for the test.
* ``python -m repro_torch.launch.dryrun`` end to end on internlm2-1.8b
  ``decode_32k`` over ``(16, 16)`` with ``--tag _test``, as the
  reference's own test runs its dry run: status ``ok``, FLOPs and
  collective bytes above 0; the file is removed.
* A fake rank against a real one: the mesh step of a ``(2, 2)`` cell at
  the smoke size, run on four gloo ranks on real tensors under
  ``OpCost`` (``tests/_torch_lm_dist.py:dryrun_suite``), gives ranks 0 and
  3 the argument bytes, state bytes, FLOPs and collective bytes by kind
  that the dry run's fake ranks 0 and 3 of the same cell count under
  ``FakeTensorMode`` (a subprocess: the fake process group is the
  process's own).

* The cells the layout repairs brought under an H100's 80 GB a rank
  (:data:`REPAIRED`: the plain MoE layer's expert blocks, attention
  scored in blocks of queries, the cross-entropy over token chunks,
  zamba2's site caches gathered one at a time), each traced by the dry
  run in a subprocess of its own: the rank's peak under 80 GB, and its
  argument bytes equal, byte for byte, to the sums of the reference's
  per-device shard shapes of the cell's state and batch
  (``param_shardings`` / ``serve_shardings`` / ``data_shardings`` on
  ``jax.eval_shape`` trees over its production mesh of host devices).

The fake process group and the reference's dry run (which sets
``XLA_FLAGS`` for its process) run in subprocesses only.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_dist as TD  # noqa: E402
import test_torch_dryrun_bytes as DB  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.launch import input_specs as tIS  # noqa: E402
from repro_torch.roofline import analysis as tR  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELLS = [(a, s.name) for a in treg.ARCH_IDS for s in SHAPES]

#: (2, 2) cells at the smoke size: float32 configs, shapes of 8 rows
FAKE_CASES = {
    "internlm2_train": dict(arch="internlm2-1.8b", shape=dict(
        name="t", seq_len=16, global_batch=8, kind="train")),
    "deepseek_opt_train": dict(arch="deepseek-v2-lite-16b", opt=True,
                               shape=dict(name="t", seq_len=16,
                                          global_batch=8, kind="train")),
    "mamba2_opt_prefill": dict(arch="mamba2-780m", opt=True, shape=dict(
        name="p", seq_len=32, global_batch=8, kind="prefill")),
    "internlm2_decode": dict(arch="internlm2-1.8b", shape=dict(
        name="d", seq_len=16, global_batch=8, kind="decode")),
    "zamba2_decode": dict(arch="zamba2-1.2b", shape=dict(
        name="d", seq_len=16, global_batch=8, kind="decode")),
}
FAKE_RANKS = (0, 3)


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import repro.configs.base as jbase
    import repro.configs.registry as jreg
    import repro.launch.input_specs as jIS
    import repro.roofline.analysis as jR
    return dict(base=jbase, reg=jreg, IS=jIS, R=jR)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_the_reference(ref, arch, shape):
    jcfg, tcfg = ref["reg"].get_config(arch), treg.get_config(arch)
    jshape = ref["base"].SHAPES_BY_NAME[shape]
    tshape = {s.name: s for s in SHAPES}[shape]
    want = ref["IS"].input_specs(jcfg, jshape)
    got = tIS.input_specs(tcfg, tshape)
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.device.type == "meta"
        assert tuple(v.shape) == tuple(want[k].shape)
        assert str(v.dtype).split(".")[-1] == np.dtype(want[k].dtype).name
    assert tIS.cell_is_applicable(tcfg, tshape) \
        == ref["IS"].cell_is_applicable(jcfg, jshape)
    assert tR.model_flops(tcfg, tshape) == ref["R"].model_flops(jcfg, jshape)


def test_compute_terms_match_the_reference(ref, monkeypatch):
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(tR, name, getattr(ref["R"], name))
    rng = np.random.default_rng(0)
    for _ in range(20):
        kw = dict(flops_per_chip=float(rng.uniform(0, 1e15)),
                  bytes_per_chip=float(rng.uniform(0, 1e12)),
                  coll_bytes_per_chip=float(rng.uniform(0, 1e11)),
                  chips=int(rng.choice([256, 512])),
                  model_flops_global=float(rng.uniform(0, 1e17)))
        got, want = tR.compute_terms(**kw), ref["R"].compute_terms(**kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.dominant == want.dominant
        assert got.step_time_s == want.step_time_s
    zero = dict(flops_per_chip=0.0, bytes_per_chip=0.0,
                coll_bytes_per_chip=0.0, chips=256, model_flops_global=0.0)
    assert dataclasses.asdict(tR.compute_terms(**zero)) \
        == dataclasses.asdict(ref["R"].compute_terms(**zero))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + str(ROOT / "tests")
    return env


def test_dryrun_single_cell_end_to_end():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "internlm2-1.8b", "--shape", "decode_32k", "--tag", "_test",
         "--force"],
        capture_output=True, text=True, env=_env(), timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    path = ROOT / "experiments" / "dryrun_torch" / "16x16_test.json"
    try:
        rec = json.loads(path.read_text())["internlm2-1.8b|decode_32k"]
    finally:
        path.unlink()
    assert rec["status"] == "ok"
    assert rec["mesh"] == "16x16" and rec["chips"] == 256
    assert rec["flops_per_chip"] > 0
    assert rec["collective_bytes_per_chip"] > 0
    assert rec["memory"]["argument_bytes"] > 0
    assert rec["memory"]["code_bytes"] is None
    assert rec["dominant"] in ("compute", "memory", "collective")


_FAKE_SCRIPT = r"""
import json, sys
import _torch_lm_dist as LD
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as D, mesh as M
cases, ranks = json.loads(sys.argv[1]), json.loads(sys.argv[2])
out = {}
for r in ranks:
    mesh = M.fake_mesh((2, 2), ("data", "model"), rank=r)
    res = {}
    for name, c in cases.items():
        got = D.trace_cell(LD._decode_cfg(c), ShapeConfig(**c["shape"]),
                           mesh, c.get("opt", False))
        res[name] = dict(argument_bytes=got["memory"]["argument_bytes"],
                         state_bytes=got["state_bytes"], flops=got["flops"],
                         collectives=got["collectives"])
    res["coords"] = [mesh.get_coordinate()[0], mesh.get_coordinate()[1]]
    out[str(r)] = res
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def fake_and_real(tmp_path_factory):
    proc = subprocess.Popen(
        [sys.executable, "-c", _FAKE_SCRIPT, json.dumps(FAKE_CASES),
         json.dumps(list(FAKE_RANKS))], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=_env(), cwd=ROOT)
    real = TD.run("_torch_lm_dist:dryrun_suite", (2, 2), args=(FAKE_CASES,),
                  tmp_dir=tmp_path_factory.mktemp("dryrun"), kind="lm")
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    fake = json.loads(out.strip().splitlines()[-1])
    return {int(r): v for r, v in fake.items()}, real


def test_meshes_over_a_real_group(fake_and_real):
    """``make_dev_mesh`` and a mesh of the group's size build over the
    real gloo group; a production mesh of 256 ranks is refused there."""
    for rank in fake_and_real[1]:
        assert rank["meshes"] == [((2, 2), ("data", "model"), "cpu")] * 2
        assert "256" in rank["refused"] and "gloo" in rank["refused"]


@pytest.mark.parametrize("name", list(FAKE_CASES))
@pytest.mark.parametrize("rank", FAKE_RANKS)
def test_fake_rank_counts_equal_a_real_rank(fake_and_real, rank, name):
    fake, real = fake_and_real
    assert fake[rank]["coords"] == real[rank]["coords"] \
        == [rank // 2, rank % 2]
    got, want = fake[rank][name], real[rank][name]
    assert got["argument_bytes"] == want["argument_bytes"] > 0
    assert got["state_bytes"] == want["state_bytes"] > 0
    assert got["flops"] == want["flops"] > 0
    assert got["collectives"] == want["collectives"]
    assert sum(v for k, v in got["collectives"].items() if k != "count") > 0


# ------------------------------------------------------ the repaired cells

#: cells over 80 GB a rank before the layout repairs: (arch, shape,
#: multi-pod)
REPAIRED = {
    "deepseek_train": ("deepseek-v2-lite-16b", "train_4k", False),
    "llama_prefill": ("llama3.2-3b", "prefill_32k", False),
    "llama_train": ("llama3.2-3b", "train_4k", False),
    "seamless_train": ("seamless-m4t-medium", "train_4k", False),
    "zamba2_long_2pod": ("zamba2-1.2b", "long_500k", True),
}
#: an H100's memory, in bytes
CARD_BYTES = 80e9

_REPAIRED_PORT = r"""
import json, sys
from repro_torch.launch import dryrun as D
arch, shape, pod = json.loads(sys.argv[1])
rec = D.run_cell(arch, shape, pod)
print(json.dumps(dict(status=rec["status"], peak=rec.get("peak_bytes"),
                      argument=rec.get("memory", {}).get("argument_bytes"),
                      error=rec.get("error"))))
"""

@pytest.fixture(scope="module")
def repaired():
    """Each repaired cell's dry-run record (one subprocess a cell) and the
    reference's argument bytes of every cell (one subprocess), all run at
    once."""
    pytest.importorskip("jax")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", _REPAIRED_PORT, json.dumps(cell)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT) for name, cell in REPAIRED.items()}
    procs["reference"] = DB._run(DB._REFERENCE, env, {
        name: (arch, shape, False, pod, False)
        for name, (arch, shape, pod) in REPAIRED.items()})
    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=900)
        assert proc.returncode == 0, f"{name}: {stderr[-3000:]}"
        out[name] = json.loads(stdout.strip().splitlines()[-1])
    return out


@pytest.mark.parametrize("name", list(REPAIRED))
def test_repaired_cell_fits_the_card(repaired, name):
    got = repaired[name]
    assert got["status"] == "ok", got["error"]
    assert 0 < got["peak"] < CARD_BYTES
    assert got["argument"] == repaired["reference"][name]["argument"] > 0
