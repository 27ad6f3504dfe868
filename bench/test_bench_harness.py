"""CPU tests of the benchmark harness: discovery of every cell and metric
by name, the contract's shape of ``BENCHMARK.json``, the yardstick's
counts against hand computations, the import guard, runs of every cell
at the smoke size (sound, and with the timed path broken underneath),
and the exits without a card or without the program.

The smoke size is the program's ``-smoke`` config with the same mix
kinds at short sequences; the card's runs are ``bench/run.py``'s."""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import pathlib
import re
import subprocess
import sys

import pytest
import torch

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from benchkit import cli, counts, guard, spec  # noqa: E402

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCHMARK["workloads"]]
METRICS = [m["name"] for m in BENCHMARK["per_layer"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")

#: the program's "-smoke" sizes of each configuration
SMOKE = {
    "internlm2-1.8b": dict(
        program_arch="internlm2-1.8b-smoke", num_hidden_layers=2,
        hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, intermediate_size=128, vocab_size=256),
}
SEED = 2 ** 31 + 4097


def smoke(name: str) -> spec.Cell:
    """Cell ``name`` at the smoke size, its limits as committed."""
    c = spec.cell(name)
    mix = dict(c.mix, seq_len=64) if c.mix["kind"] == "train" \
        else dict(c.mix, seq_len=48, checked_forwards=2)
    return dataclasses.replace(
        c, config=dict(c.config, **SMOKE[c.config["name"]]), mix=mix)


def run(name: str, **hooks):
    res, _ = cli.run_cell(smoke(name), SEED, 0.5, False,
                          torch.device("cpu"), 0.0, **hooks)
    return res


@functools.lru_cache(maxsize=None)
def sound(name: str):
    """A sound run of cell ``name`` at the smoke size (one a process)."""
    return run(name)


# ------------------------------------------------------------ discovery
@pytest.mark.parametrize("name", CELLS)
def test_every_cell_is_found_by_name(name):
    c = spec.cell(name)
    assert c.driver.run and c.reference.init and c.limits
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    assert c.entry["chips"] == 1


@pytest.mark.parametrize("name", METRICS)
def test_every_per_layer_metric_has_a_reader(name):
    read = spec.reader(name)
    assert callable(read)
    m = {m["name"]: m for m in BENCHMARK["per_layer"]}[name]
    assert m["moves"] in {e["name"] for e in BENCHMARK["end_to_end"]}


def test_benchmark_json_keeps_to_the_contract():
    b = BENCHMARK
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["bench"] and b["command"][1].startswith("bench/")
    assert 1 <= b["run_seconds"] <= 51
    for entry in b["configs"] + b["workloads"] + b["end_to_end"] \
            + b["per_layer"]:
        assert NAME.match(entry["name"]), entry["name"]
    for c in b["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert sorted(c["reduced"]) == sorted(conf["reduced"])
        assert not any(k.endswith(("_dim", "_rank", "_size")) and k not in
                       ("chunk_size", "vocab_size") for k in c["reduced"])
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    for entry in b["configs"] + b["workloads"] + b["per_layer"]:
        for key in ("why", "layer", "source"):
            text = entry.get(key, "x")
            assert 1 <= len(text) <= 200 and "\n" not in text \
                and "\t" not in text, (entry["name"], key)
    for m in b["end_to_end"] + b["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    assert len(json.dumps(b)) <= 64 * 1024
    seconds = (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200
    assert seconds <= 43200


# ------------------------------------------------------------ counts
def test_flop_counts_against_a_hand_computation():
    train = spec.cell("internlm2-train")
    # internlm2-1.8b: per layer q, k, v, o and the SwiGLU MLP; the head
    layer = 2048 * 128 * (16 + 2 * 8) + 16 * 128 * 2048 + 3 * 2048 * 8192
    weights = 24 * layer + 2048 * 92544
    attn = 24 * 2 * 2 * 16 * 128 * (4096 * 4097 // 2)      # a sequence
    want = 6 * weights * 8 * 4096 + 3 * 8 * attn
    got = counts.model_flops(train.reference, train.config, train.mix)
    assert got == want
    assert 11.3e9 < got / (8 * 4096) < 11.5e9               # a token
    pre = spec.cell("internlm2-prefill")
    # one prompt of 32,768 tokens: the layers, causal attention, the head
    # at the last position
    attn = 24 * 2 * 2 * 16 * 128 * (32768 * 32769 // 2)
    want = 2 * 24 * layer * 32768 + attn + 2 * 2048 * 92544
    assert counts.model_flops(pre.reference, pre.config, pre.mix) == want


def test_mfu_reads_model_flops_over_device_busy_time():
    from types import SimpleNamespace
    read = spec.reader("mfu.prefill")
    ctx = SimpleNamespace(kind="prefill", units=4, flops_per_unit=2.5e14,
                          busy_s=10.0, window_s=12.0)
    assert math.isclose(read(ctx), 100 * 4 * 2.5e14 / (10 * 989e12))
    assert read(SimpleNamespace(**{**vars(ctx), "busy_s": 0.0})) is None
    assert read(SimpleNamespace(**{**vars(ctx), "units": 0})) is None
    assert spec.reader("mfu.train")(ctx) is None


# ------------------------------------------------------------ the guard
@pytest.mark.parametrize("modules,bad", [
    (["repro_torch", "repro_torch.models.transformer", "torch"], []),
    (["repro", "torch"], ["repro"]),
    (["repro.models.transformer"], ["repro"]),
    (["jax.numpy", "jaxlib", "flax.linen"], ["flax", "jax", "jaxlib"]),
    (["jaxtyping", "reprolib"], []),
])
def test_import_guard_compares_whole_top_level_names(modules, bad):
    assert guard.forbidden_loaded(modules) == bad


def test_the_harness_and_the_port_load_no_jax():
    code = ("import sys; sys.path[:0] = ['bench', 'src']\n"
            "from benchkit import cli, device, program, train, prefill\n"
            "from references import dense_decoder\n"
            "import repro_torch.launch.train, repro_torch.models.transformer\n"
            "from benchkit import guard; print(guard.forbidden_loaded())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, check=True, timeout=120)
    assert out.stdout.strip() == "[]"


# ------------------------------------------------------------ runs
@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_reports_every_number(name):
    res = sound(name)
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == set(spec.cell(name).limits)
    assert all(math.isfinite(v) for v in res["readings"].values())
    assert res["correct"] == all(c["value"] <= c["limit"]
                                 for c in res["checks"].values())
    assert set(res["metrics"]) == {m["name"] for m in
                                   spec.cell(name).end_to_end}


def _unchanged(step_fn):
    """A step that computes its metrics and returns its state as it was."""
    def step(state, batch):
        copy = torch.utils._pytree.tree_map(
            lambda t: t.clone() if isinstance(t, torch.Tensor) else t, state)
        return state, step_fn(copy, batch)[1]
    return step


def _half_batch(step_fn):
    """A step that leaves out half of the batch: the mean over the rest."""
    return lambda state, batch: step_fn(
        state, {k: v[:len(v) // 2] for k, v in batch.items()})


def _altered(forward):
    """Each prompt's answer altered where it is produced."""
    return lambda tokens: torch.roll(forward(tokens), 1, dims=-1)


TRAIN = [n for n in CELLS if spec.cell(n).mix["kind"] == "train"]
PREFILL = [n for n in CELLS if spec.cell(n).mix["kind"] == "prefill"]


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("fault", [_unchanged, _half_batch])
def test_a_broken_train_step_is_not_correct(name, fault):
    good, bad = sound(name)["readings"], run(name, step_of=fault)
    assert not bad["correct"]
    assert any(bad["readings"][k] > 3 * good[k] for k in bad["checks"])


@pytest.mark.parametrize("name", PREFILL)
def test_an_altered_answer_is_not_correct(name):
    good, bad = sound(name)["readings"], run(name, forward_of=_altered)
    assert not bad["correct"]
    assert all(bad["readings"][k] > 3 * good[k] for k in bad["checks"])


@pytest.mark.parametrize("readings,within", [
    ({"a": 1.0, "b": 2.0}, True),
    ({"a": 1.5, "b": 2.0}, False),
    ({"a": 1.0, "b": 2.5}, False),
])
def test_correct_needs_every_number_within_its_limit(readings, within):
    ok, checks = cli.judge(readings, {"a": 1.0, "b": 2.0})
    assert ok is within
    assert checks == {k: {"value": v, "limit": {"a": 1.0, "b": 2.0}[k]}
                      for k, v in readings.items()}


# ------------------------------------------------------------ exits
def test_no_card_exits_without_a_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    assert cli.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                     "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


def test_without_the_program_it_exits_without_a_result(tmp_path):
    (tmp_path / "BENCHMARK.json").write_text(
        (ROOT / "BENCHMARK.json").read_text())
    subprocess.run(["cp", "-r", str(BENCH), str(tmp_path / "bench")],
                   check=True)
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", CELLS[0], "--seed",
         "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path, text=True,
        capture_output=True, timeout=120, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout == ""
