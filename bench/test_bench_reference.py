"""CPU tests of the plain references (``bench/references/``) against the
program (``repro_torch``) at the smoke size of each configuration, in
float32: the same weights give the same logits, loss and gradients. The
test imports both; the references import nothing of the program.

The control (the references' products in fp8) is held here at the smoke
size against the sound program: its readings must be the larger. On the
card it runs at the cells' own sizes: ``bench/calibrate.py``."""

from __future__ import annotations

import dataclasses
import pathlib
import sys

import pytest
import torch

BENCH = pathlib.Path(__file__).resolve().parent
for p in (str(BENCH), str(BENCH.parent / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from benchkit import inputs  # noqa: E402
from references import plain  # noqa: E402
from test_bench_harness import SEED, smoke  # noqa: E402

CONFIGS = {"internlm2-1.8b": "internlm2-train"}


def f32_pair(name):
    """(smoke cell, the program's smoke config in float32, f32 weights)."""
    from repro_torch.configs.registry import get_config
    cell = smoke(CONFIGS[name])
    config = dict(cell.config, torch_dtype="float32")
    cfg = dataclasses.replace(get_config(config["program_arch"]),
                              dtype="float32")
    params = cell.reference.init(inputs.generator("cpu", SEED, "weights"),
                                 config, "cpu")
    return cell, config, cfg, params


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reference_logits_equal_the_programs(name):
    from repro_torch.models import transformer as T
    cell, config, cfg, params = f32_pair(name)
    tokens, _ = inputs.token_batch(SEED, 0, 2, 40, config["vocab_size"],
                                   "cpu")
    got = T.forward(params, cfg, tokens, logits_mode="last")[0][:, -1]
    want = cell.reference.last_logits(params, tokens, config,
                                      plain.Precision("f32"))
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reference_loss_and_gradients_equal_the_programs(name):
    from repro_torch.train import train_loop as TL
    cell, config, cfg, params = f32_pair(name)
    tokens, labels = inputs.token_batch(SEED, 1, 2, 40, config["vocab_size"],
                                        "cpu")
    loss, _, grads = TL.grads_of(params, cfg, {"tokens": tokens,
                                               "labels": labels})
    named = plain.leaves(params)
    master = [t.clone().requires_grad_() for _, t in named]
    ref_loss = cell.reference.loss(
        plain.unflatten([n for n, _ in named], master), tokens, labels,
        config, plain.Precision("f32"))
    ref_grads = torch.autograd.grad(ref_loss, master)
    torch.testing.assert_close(loss, ref_loss.detach(), rtol=1e-5, atol=0)
    for (n, g), want in zip(plain.leaves(grads), ref_grads):
        torch.testing.assert_close(g, want, rtol=1e-4, atol=1e-6, msg=n)


@pytest.mark.parametrize("name", sorted(CONFIGS.values()))
def test_the_control_reads_above_the_program(name):
    cell = smoke(name)
    driver = cell.driver
    want = driver.reference_records(cell, SEED, torch.device("cpu"))
    control = driver.reference_records(cell, SEED, torch.device("cpu"),
                                       "fp8")
    built = driver.setup(cell, SEED, torch.device("cpu"))
    sound = driver.readings(built["records"], want)
    bad = driver.readings(control, want)
    assert bad["loss_gap"] > sound["loss_gap"]
    assert bad["grad_gap"] > sound["grad_gap"]


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "references").glob("*.py"):
        text = path.read_text()
        for name in ("repro_torch", "import repro", "from repro", "jax",
                     "benchkit"):
            assert name not in text, (path.name, name)


def test_the_references_know_every_configuration():
    from benchkit import spec
    for name in CONFIGS.values():
        cell = spec.cell(name)
        assert cell.reference.matmul_params(cell.config)["layers"] > 0


@pytest.mark.parametrize("block", [1, 7, 40, 64])
def test_attention_by_query_blocks_equals_one_block(block, monkeypatch):
    """The reference's attention over blocks of queries, each against the
    keys up to its last query, equals the whole causal softmax."""
    from references import dense_decoder as D
    cell = smoke("internlm2-prefill")
    config = dict(cell.config, torch_dtype="float32")
    params = plain.layer_trees(D.init(
        inputs.generator("cpu", SEED, "weights"), config, "cpu"))[0]["attn"]
    x = torch.randn((2, 40, config["hidden_size"]),
                    generator=inputs.generator("cpu", SEED, "x"))
    prec = plain.Precision("f32")
    whole = D._attention(params, x, config, prec)
    monkeypatch.setattr(D, "SCORE_BYTES", 4 * 2 * 4 * block)
    torch.testing.assert_close(D._attention(params, x, config, prec), whole,
                               rtol=1e-6, atol=1e-6)
