"""Run one cell of the benchmark once and print its result.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result as one JSON object; the last lines of standard error name each
number the output check compared, with its limit. Exits 2 without a CUDA
card (or with fewer than the cell asks for), and 3 if the process holds a
JAX module once the window has closed.

The run keeps PyTorch's and the BLAS libraries' CPU thread pools at one
thread: the node's host work is one thread, and on a host whose cores
are shared a pool's idle threads only take time from it.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# read by the thread pools when torch and numpy load, so set before either
for _pool in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_pool] = "1"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench import core

    bench = core.load_json(ROOT, "BENCHMARK.json")
    workload, _ = core.cell(bench, args.workload)
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < workload["chips"]:
        print(f"{args.workload} needs {workload['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, log, _ = core.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                   device="cuda", t0=T0)
    bad = core.forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: nothing it runs may load JAX or the JAX package",
              file=sys.stderr)
        return 3
    for line in log:
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
