"""One run of one cell: find the cell's configuration, traffic, driver,
metrics and limits by name, set up, run the window, read the metrics,
check what the window produced (and what the driver adds once the
metrics are read) against the reference.

Everything a cell needs is a file found by a name in BENCHMARK.json:
`configs/<config>.json` (its `driver` names `drivers/<driver>.py`),
`traffic/<traffic>.json`, `e2e/<metric>.py` and `metrics/<metric>.py`
(each a `read(run)`), `limits/<workload>.json`.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import os
import random
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# modules no run may hold once its window closes, by whole top-level name
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "badger_amcl_tpu"})


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    latencies: list  # s, every scan of the window
    window_s: float
    setup_s: float
    counts: dict
    info: dict
    device_type: str
    trace: object = None  # trace.Trace of the traced stretch
    traced_scans: int = 0
    work: list = dataclasses.field(default_factory=list)  # (poses, pairs, texel bytes)


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def forbidden_modules() -> list:
    """The forbidden top-level names among the loaded modules."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)


def cell(bench: dict, workload: str):
    """(the workload's entry, its configuration's entry), by the name
    BENCHMARK.json lists."""
    for w in bench["workloads"]:
        if w["name"] == workload:
            cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
            return w, cfg
    raise KeyError(f"BENCHMARK.json lists no workload {workload!r}")


def check_names() -> tuple:
    from perfbench.reference.check import NAMES

    return NAMES


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(base[k], v) if isinstance(v, dict) and isinstance(base.get(k), dict) else v
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t0: float = None, overrides: dict = None, control: bool = False):
    """(result, the check's lines for standard error, the readings). The
    result is the line the benchmark prints; overrides ({"config": ...,
    "traffic": ...}) shrink a cell for the tests."""
    import torch

    t0 = time.perf_counter() if t0 is None else t0
    bench = load_json(ROOT, "BENCHMARK.json")
    wl, cfg_entry = cell(bench, workload)
    overrides = overrides or {}
    config = _merge(load_json(ROOT, cfg_entry["file"]), overrides.get("config", {}))
    traffic = _merge(load_json(HERE, "traffic", wl["traffic"] + ".json"),
                     overrides.get("traffic", {}))
    limits = load_json(HERE, "limits", workload + ".json")
    missing = set(check_names()) - set(limits)
    if missing:
        raise KeyError(f"limits/{workload}.json has no limit for {sorted(missing)}")
    driver_mod = importlib.import_module("perfbench.drivers." + config["driver"])
    cuda = device.startswith("cuda")
    seed = int(seed) % (1 << 62)
    workdir = tempfile.mkdtemp(prefix="perfbench-")
    here = os.getcwd()
    os.chdir(workdir)
    try:
        driver = driver_mod.DRIVER(config, traffic, seed, device, workdir)
        max_steps = int(seconds * 3000) + 4 * int(traffic["trace_s"] * driver.rate) + 1000
        driver.setup(max_steps)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t0
        tracer = None
        if trace:
            from perfbench.trace import Tracer

            tracer = Tracer()
        win = driver.window(seconds, random.Random(seed + 40), traffic["check"], tracer)
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        run = Run(latencies=win["latencies"], window_s=win["window_s"], setup_s=setup_s,
                  counts=dict(driver.counts), info=dict(driver.info),
                  device_type="cuda" if cuda else "cpu")
        log = [f"setup_s {setup_s:.4f}; window {run.window_s:.4f} s, {len(run.latencies)} "
               f"scans; counts {run.counts}; info {run.info}"]
        if tracer is not None:
            run.trace = tracer.reduce()
            run.traced_scans = driver.trace_steps
            # the profiler slows the host: the pace of the window's untraced
            # rest beside the traced stretch's, for the idle share's bias
            n_rest, s_rest = win["untraced"]
            log.append(f"traced {run.traced_scans} scans in {run.trace.window_s:.4f} s, "
                       f"device busy {run.trace.busy_s():.4f} s; untraced rest {n_rest} scans "
                       f"in {s_rest:.4f} s")
            for role, n_poses, n_active, msg in win["trace_work"]:
                poses = int(n_active) if n_active is not None else n_poses
                pairs, texel = driver.work(role, poses, msg)
                run.work.append((poses, pairs, texel))
        if cuda:
            log.append(f"arms {driver.arms()}")
        if run.counts.get("window_captures"):
            log.append(f"WARNING: {run.counts['window_captures']} graph captures inside the "
                       "window")
        kind = "end_to_end" if not trace else "per_layer"
        metrics = {}
        for m in bench[kind]:
            if not applies(m, workload):
                continue
            mod = importlib.import_module(("perfbench.e2e." if kind == "end_to_end"
                                           else "perfbench.metrics.") + m["name"])
            value = mod.read(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        records, map_input, mount = win["records"], driver.map_input, driver.mount
        for k, recs in driver.after_window().items():
            records[k] = records.get(k, []) + recs
        # a sample the traffic asks for that the window left empty compared nothing
        empty = sorted(k for k in traffic["check"] if not records.get(k))
        driver.close()
        del driver, win
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        from perfbench.reference import check

        t_ref = time.perf_counter()
        read = check.readings(records, config, map_input, mount, device, control=control)
        log.append(f"reference_s {time.perf_counter() - t_ref:.4f}")
        correct, rows = check.verdict(read["program"], limits)
        correct = correct and not empty
    finally:
        os.chdir(here)
        shutil.rmtree(workdir, ignore_errors=True)

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": wl["chips"] if cuda else 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(run.latencies), "failed": 0,
              "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    log.append(f"compared {read['counts']}")
    glob = read["phases"]["global"]
    if any(v is not None for v in glob.values()):
        log.append(f"compared in global localization {read['global_counts']}")
    if empty:
        log.append(f"the window left the samples {empty} empty")
    for k, v, lim in rows:
        line = f"check {k}: {'none compared' if v is None else repr(v)} (limit {lim}"
        if glob[k] is not None:
            line += f"; normal {read['phases']['normal'][k]!r}, global {glob[k]!r}"
        log.append(line + ")")
    return result, log, read
