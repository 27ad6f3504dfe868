"""Run one cell of the benchmark of ``repro_torch`` on this machine's card.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout: ``src/`` (the port) and ``bench/`` (the
harness) go on the path here. See ``bench/README.md``.
"""

import time

T_START = time.perf_counter()

import pathlib  # noqa: E402
import sys  # noqa: E402

BENCH = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

if __name__ == "__main__":
    if not (BENCH.parent / "src" / "repro_torch").is_dir():
        print(f"bench: no src/repro_torch beside {BENCH}: run it from the "
              f"root of a checkout of the repository", file=sys.stderr)
        sys.exit(2)
    from benchkit import cli
    sys.exit(cli.main(t_start=T_START))
