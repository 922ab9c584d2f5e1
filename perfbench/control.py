"""The output check's readings over many seeds in one process: for each
seed a short window of the cell, then the widest gap of each compared
number for the program and for the control (the reference computed in
bfloat16 and put in the program's place), and whether each comes out
correct under the cell's limits (the control must not). The limits in
`limits/<workload>.json` are set from these readings; the benchmark's
own runs never run the control.

    python3 perfbench/control.py --workload <name> --seconds <s> --seeds <n> [<n> ...]

One JSON line per seed on standard output.
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    import torch

    from perfbench import core
    from perfbench.reference import check

    if not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t0 = time.perf_counter()
        result, log, read = core.run_cell(args.workload, seed, args.seconds, False,
                                          device="cuda", control=True)
        limits = core.load_json(core.HERE, "limits", args.workload + ".json")
        control_ok, rows = check.verdict(read["control"], limits)
        for line in log:
            print(line, file=sys.stderr)
        for k, v, lim in rows:
            print(f"control {k}: {v!r} (limit {lim})", file=sys.stderr)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": result["correct"],
                          "control_correct": control_ok, "metrics": result["metrics"],
                          "program": read["program"], "control": read["control"],
                          "compared": read["counts"], "seconds": time.perf_counter() - t0}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
