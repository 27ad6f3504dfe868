"""Readings from which a cell's limits on ``correct`` are set, at the
cell's own sizes, on the card:

    python3 bench/calibrate.py --workload <cell> --seeds 11,12,... \
        --control-seeds 11,12,13

For each seed the program's readings against the plain reference (the
lower reading: the largest over the seeds); for each control seed the
control's, the reference computed with fp8 products in the program's
place (the upper reading: the smallest), and for a training cell the
program with half of each batch left out (a planted fault); and whether
the committed limits (``bench/limits/<cell>.json``) judge each set of
readings correct, by the rule a run's ``correct`` uses. One JSON line a
seed on standard output. The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

BENCH = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]


def half_batch(step_fn):
    """The planted fault: half of each batch left out, the mean taken
    over the rest."""
    return lambda state, batch: step_fn(
        state, {k: v[:len(v) // 2] for k, v in batch.items()})


def worst_leaves(got, want, n=5):
    """The ``n`` leaves of the first gradient whose norms differ most."""
    g, w = got["first_grad"], want["first_grad"]
    rows = sorted(((abs(g[k] - w[k]) / w[k], k, g[k], w[k]) for k in w),
                  reverse=True)
    return [[k, gap, a, b] for gap, k, a, b in rows[:n]]


def train_readings(cell, seed, control, dev):
    from benchkit import program
    d = cell.driver
    built = d.setup(cell, seed, dev)
    got = built["records"]
    del built
    program.release(dev)
    want = d.reference_records(cell, seed, dev)
    out = {"program": d.readings(got, want),
           "worst_leaves": worst_leaves(got, want),
           "losses": [got["losses"], want["losses"]]}
    if control:
        out["control"] = d.readings(
            d.reference_records(cell, seed, dev, "fp8"), want)
        program.release(dev)
        built = d.setup(cell, seed, dev, step_of=half_batch)
        out["half_batch"] = d.readings(built["records"], want)
        del built
    program.release(dev)
    return out


def prefill_readings(cell, seed, control, dev):
    import torch
    from benchkit import program
    d = cell.driver
    which = d.checked(seed, 1000, cell.mix["checked_forwards"])
    forward = d.build(cell, seed, dev)
    with torch.no_grad():
        got = [forward(d.prompts(cell, seed, i, dev)) for i in which]
    del forward
    program.release(dev)
    want = d.reference_logits(cell, seed, which, dev)
    out = {"program": d.readings(got, want)}
    if control:
        out["control"] = d.readings(
            d.reference_logits(cell, seed, which, dev, "fp8"), want)
    program.release(dev)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args()
    import torch
    from benchkit import cli, device, spec
    cell = spec.cell(args.workload)
    dev = torch.device("cuda", 0)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    read = train_readings if cell.mix["kind"] == "train" \
        else prefill_readings
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        out = read(cell, seed, seed in controls, dev)
        # each set of readings judged by the committed limits, as a run's
        # ``correct`` judges them
        out["correct"] = {k: cli.judge(out[k], cell.limits)[0]
                          for k in ("program", "control", "half_batch")
                          if k in out}
        print(json.dumps(dict(cell=cell.name, seed=seed, **out,
                              seconds=time.perf_counter() - t0,
                              card=device.power_limit())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
