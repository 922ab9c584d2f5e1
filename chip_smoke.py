#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

Builds the port's CUDA kernels from badger_amcl_tpu_torch/csrc, holds each
kernel against its plain PyTorch version at the flagship shapes (50,000
particles x 720 beams on a 1024^2 map at 0.05 m), drives the 2D
likelihood-field MCL step (`mcl_step_2d`, `sensor_resample_step`) in the
steady, tracking and spread regimes plus the steady regime on the "lf"
backend, checks that each regime went through its kernel and produced a
sane filter state, and times the likelihood, the step and every kernel
with CUDA events.

    python3 chip_smoke.py

Prints progress lines, then a {"kernels": [...]} JSON line, the card's
name and power limit, and as its last line
{"ok": true, "device": {...}}. Exits nonzero, with no result line, when
CUDA is unavailable, the package is missing or any phase fails.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

N_PARTICLES = 50_000
N_BEAMS = 720
MAP_CELLS = 1024
ITERS = 25
WARMUP = 3
# bench.py's regimes: pose covariance of the initial cloud
REGIMES = {
    "steady": (0.004, 0.004, 0.0004),
    "tracking": (0.02, 0.02, 0.002),
    "spread": (2.0, 2.0, 1.0),
}
ODOM = ([0.1, 0.0, 0.02], [0.1, 0.0, 0.02], [0.1, 0.0, 0.02], [0.1] * 5)
ROOT = os.path.dirname(os.path.abspath(__file__))


def log(msg):
    print(msg, flush=True)


class Failure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise Failure(msg)


def cuda_ms(fn, iters=ITERS, warmup=WARMUP):
    """Median milliseconds of fn() over `iters` calls, CUDA events, after
    a warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def nvidia_smi_line():
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return proc.stdout.strip().splitlines()[0] if proc.stdout.strip() else proc.stderr.strip()


def phase_kernels(dev, omap, scan, states):
    """Each kernel against its plain version at the flagship shapes."""
    import torch

    from badger_amcl_tpu_torch.ops import corr_kernel as ck
    from badger_amcl_tpu_torch.ops import lf_kernel as lk
    from badger_amcl_tpu_torch.ops import spread_kernel as sk
    from badger_amcl_tpu_torch.sensors import planar

    sp = planar.PlanarScanParams()
    valid = scan.valid()
    results = {}

    # corr_table at the 24/32/64-row windows (steady -> tight, tracking ->
    # narrow, tracking cloud in the standard window)
    corr = []
    for regime, rows in (("steady", 24), ("tracking", 32), ("tracking", 64)):
        spose = planar.coord_add(sp.scanner_pose, states[regime][1].poses)
        pre = ck.corr_prepass(omap, spose, scan.ranges, scan.angles, valid, dedup=True)
        check(bool(pre["fits"]), f"corr prepass does not fit the {regime} cloud")
        j0 = {24: pre["j0_tight"], 32: pre["j0_narrow"], 64: pre["j0"]}[rows]
        org = ck.table_origin(pre, j0)
        args = (omap.corr_psi_pad, pre["off"], pre["nu"], pre["t_n"], org, N_BEAMS, rows)
        got = ck.corr_table(*args)
        want = ck.corr_table_plain(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        check(err <= 1e-5 * scale, f"corr_table[{rows}] err {err} > 1e-5 x {scale}")
        ms = cuda_ms(lambda: ck.corr_table(*args))
        plain_ms = cuda_ms(lambda: ck.corr_table_plain(*args))
        taps = int(pre["nu"].sum())
        log(f"corr_table rows={rows} ({regime}): t_n={int(pre['t_n'])} taps={taps} "
            f"max_abs_err={err:.3e} (table max {scale:.4g}) ms={ms:.4f} plain_ms={plain_ms:.4f}")
        corr.append((rows, err, ms, plain_ms))
    err = max(c[1] for c in corr)
    rows32 = [c for c in corr if c[0] == 32][0]
    results["corr_table"] = dict(max_abs_err=err, ms=rows32[2], plain_ms=rows32[3])

    # spread_term_sums in the spread regime
    spose = planar.coord_add(sp.scanner_pose, states["spread"][1].poses)
    term = planar._lf_term(sp, scan.range_max)
    got = sk.spread_term_sums(omap, spose, scan.ranges, scan.angles, valid, term)
    inputs = sk.endpoint_inputs(omap, spose, scan.ranges, scan.angles)
    qtex = sk.quantized_tex(omap)
    want = sk.spread_term_sums_plain(omap, qtex, *inputs, valid, term)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    rel = float(((got - want).abs() / want.abs().clamp(min=1e-30)).max())
    check(rel <= 1e-5, f"spread_term_sums rel err {rel} > 1e-5")
    ms = cuda_ms(lambda: sk.spread_term_sums(omap, spose, scan.ranges, scan.angles, valid,
                                             term))
    plain_ms = cuda_ms(lambda: sk.spread_term_sums_plain(omap, qtex, *inputs, valid, term))
    log(f"spread_term_sums (spread): max_abs_err={err:.3e} max_rel_err={rel:.3e} "
        f"ms={ms:.4f} plain_ms={plain_ms:.4f}")
    results["spread_term_sums"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)

    # lf_distances: bf16 texture on the steady cloud, f32 on the spread one
    lf = []
    for regime, dtype in (("steady", torch.bfloat16), ("spread", torch.float32)):
        spose = planar.coord_add(sp.scanner_pose, states[regime][1].poses)
        tex = omap.distances.to(dtype)
        got = lk.lf_distances(omap, tex, spose, scan.ranges, scan.angles)
        want = lk.lf_distances_plain(omap, tex, spose, scan.ranges, scan.angles)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        eq = float((diff == 0).float().mean())
        err = float(diff.max())
        tol = omap.resolution * math.sqrt(2.0) + (2.0 ** -7 if dtype == torch.bfloat16 else 0.0)
        check(eq >= 0.9999 and err <= tol,
              f"lf_distances {dtype}: {eq:.6f} bit-equal, max err {err} (tol {tol})")
        ms = cuda_ms(lambda: lk.lf_distances(omap, tex, spose, scan.ranges, scan.angles))
        plain_ms = cuda_ms(lambda: lk.lf_distances_plain(omap, tex, spose, scan.ranges,
                                                         scan.angles))
        log(f"lf_distances {str(dtype).split('.')[-1]} ({regime}): bit_equal={eq:.6f} "
            f"max_abs_err={err:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f}")
        lf.append((err, ms, plain_ms))
    results["lf_distances"] = dict(max_abs_err=max(x[0] for x in lf), ms=lf[0][1],
                                   plain_ms=lf[0][2])
    return results


def check_state(s, params, regime):
    import torch

    n = int(s.n_active)
    check(params.min_samples <= n <= params.max_samples, f"{regime}: n_active {n}")
    w = s.weights[:n]
    check(bool(torch.isfinite(s.weights).all()), f"{regime}: non-finite weights")
    check(abs(float(w.sum()) - 1.0) < 1e-4, f"{regime}: weights sum {float(w.sum())}")
    check(bool(torch.isfinite(s.poses).all()), f"{regime}: non-finite poses")
    check(bool(torch.isfinite(s.stats.mean).all()), f"{regime}: non-finite mean")


def pinned_step_fn(mcl, omap, sp, scan, pool, params, state, gen, backend):
    """bench.py's pinned step: full sensor update + resample, then the
    regime's cloud restored (perturbed by the output to keep a data
    dependency) so every iteration does the regime's work."""
    import torch

    poses0 = state.poses
    n = params.max_samples
    box = {"s": state, "out": None}

    def step():
        s2 = mcl.sensor_resample_step(box["s"], omap, sp, scan, pool, params,
                                      backend=backend, generator=gen)
        box["out"] = s2
        box["s"] = s2.replace(
            poses=poses0 + s2.poses.mean() * 1e-12,
            weights=torch.full_like(s2.weights, 1.0 / n),
            n_active=torch.full_like(s2.n_active, n))

    return step, box


def phase_main_path(dev, omap, scan, states):
    """Drive the main path; returns the per-kernel launch counts of this
    run only."""
    import torch

    from badger_amcl_tpu_torch import mcl
    from badger_amcl_tpu_torch.ops import corr_kernel as ck
    from badger_amcl_tpu_torch.ops import lf_kernel as lk
    from badger_amcl_tpu_torch.ops import spread_kernel as sk
    from badger_amcl_tpu_torch.sensors.planar import PlanarScanParams

    counters = {"corr_table": ck.corr_table, "spread_term_sums": sk.spread_term_sums,
                "lf_distances": lk.lf_distances}
    expect = {"steady": "corr_table", "tracking": "corr_table",
              "spread": "spread_term_sums"}
    sp = PlanarScanParams()
    for fn in counters.values():
        fn.launches = 0
    gen = torch.Generator(device=dev).manual_seed(1)
    for regime, backend in (("steady", "corr"), ("tracking", "corr"),
                            ("spread", "corr"), ("steady", "lf")):
        params, state, pool = states[regime]
        name = expect[regime] if backend == "corr" else "lf_distances"
        before = counters[name].launches
        s = state
        for _ in range(3):
            s = mcl.mcl_step_2d(s, omap, sp, scan, pool, *ODOM, params,
                                backend=backend, generator=gen)
        check_state(s, params, f"{regime}/{backend} mcl_step_2d")
        step, box = pinned_step_fn(mcl, omap, sp, scan, pool, params, state, gen, backend)
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        out = box["out"]
        check_state(out, params, f"{regime}/{backend} sensor_resample_step")
        rose = counters[name].launches - before
        check(rose > 0, f"{regime}/{backend}: {name} was not launched")
        if regime == "steady":
            err = float(out.stats.mean[:2].norm())
            check(err < 0.1, f"steady/{backend}: mean {out.stats.mean.tolist()} "
                             f"is {err:.3f} m from the truth")
        log(f"main path {regime}/{backend}: {name} launches +{rose}, n_active="
            f"{int(out.n_active)}, clusters={int(out.stats.cluster_count)}, "
            f"mean={[round(v, 4) for v in out.stats.mean.tolist()]}")
    return {k: fn.launches for k, fn in counters.items()}


def phase_reference(dev):
    """The whole step on the card (kernels) against the same step on the
    CPU (plain versions), same inputs and draws, at a small size."""
    import torch

    from badger_amcl_tpu_torch import mcl, scenario
    from badger_amcl_tpu_torch.sensors.planar import PlanarScanParams

    omap_c = scenario.build_map(448)
    scan_c = scenario.build_scan(360)
    params, state_c, pool_c = scenario.build_filter(
        4096, pose_cov=(0.02, 0.02, 0.002), min_particles=1024)
    noise_c = mcl.StepNoise.draw(torch.Generator().manual_seed(5), 4096, "cpu", odom=False)
    sp = PlanarScanParams()

    def to(x):
        if isinstance(x, torch.Tensor):
            return x.to(dev)
        if dataclasses.is_dataclass(x):
            return type(x)(**{f.name: to(getattr(x, f.name)) for f in dataclasses.fields(x)})
        return x

    p_c = mcl.likelihood_only(state_c, omap_c, sp, scan_c, backend="corr")
    p_g = mcl.likelihood_only(to(state_c), to(omap_c), sp, to(scan_c), backend="corr").cpu()
    close = ((p_g - p_c).abs() <= 1e-4 * p_c.abs()).float().mean().item()
    check(close >= 0.99, f"reference: only {close:.4f} of likelihoods agree to 1e-4")
    out_c = mcl.sensor_resample_step(state_c, omap_c, sp, scan_c, pool_c, params,
                                     backend="corr", noise=noise_c)
    out_g = mcl.sensor_resample_step(to(state_c), to(omap_c), sp, to(scan_c), to(pool_c),
                                     params, backend="corr", noise=to(noise_c))
    same = (out_g.poses.cpu() == out_c.poses).all(dim=1).float().mean().item()
    dmean = float((out_g.stats.mean.cpu() - out_c.stats.mean)[:2].norm())
    check(int(out_g.n_active) == int(out_c.n_active), "reference: n_active differs")
    check(same >= 0.99 and dmean < 0.01,
          f"reference: picks equal {same:.4f}, mean differs by {dmean:.4g} m")
    log(f"reference (4096 x 360, card vs CPU): likelihoods within 1e-4: {close:.4f}, "
        f"picks equal: {same:.4f}, mean diff {dmean:.3e} m")


def device_busy(fn, steps=5):
    """(device ms, device ops) per call of fn: the summed kernel times of a
    torch.profiler window of `steps` calls, one stream, so no overlap."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    return (sum(e.self_device_time_total for e in ev) / steps / 1e3,
            sum(e.count for e in ev) / steps)


def phase_timings(dev, omap, scan, states):
    import torch

    from badger_amcl_tpu_torch import mcl
    from badger_amcl_tpu_torch.sensors.planar import PlanarScanParams
    from badger_amcl_tpu_torch.utils.numerics import SYNCS

    sp = PlanarScanParams()
    gen = torch.Generator(device=dev).manual_seed(2)
    out = {}
    for regime, backend in (("steady", "corr"), ("tracking", "corr"),
                            ("spread", "corr"), ("steady", "lf")):
        params, state, pool = states[regime]
        like_ms = cuda_ms(lambda: mcl.likelihood_only(state, omap, sp, scan,
                                                      backend=backend))
        step, _ = pinned_step_fn(mcl, omap, sp, scan, pool, params, state, gen, backend)
        s0 = SYNCS.count
        step()
        syncs = SYNCS.count - s0
        step_ms = cuda_ms(step)
        busy_ms, ops = device_busy(step)
        key = regime if backend == "corr" else f"{regime}_{backend}"
        out[key] = dict(likelihood_ms=like_ms, step_ms=step_ms, host_syncs_per_step=syncs,
                        device_busy_ms=busy_ms, device_ops_per_step=ops,
                        device_idle_share=1.0 - busy_ms / step_ms)
        log(f"timing {key}: likelihood_ms={like_ms:.4f} step_ms={step_ms:.4f} "
            f"host_syncs_per_step={syncs} device_busy_ms={busy_ms:.4f} "
            f"device_ops_per_step={ops:.0f} idle_share={1.0 - busy_ms / step_ms:.3f}")
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a "
              "CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import badger_amcl_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port package is missing next to this script: {e}",
              file=sys.stderr)
        return 2
    from badger_amcl_tpu_torch import scenario
    from badger_amcl_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"device: {name} ({torch.cuda.device_count()} visible); nvidia-smi: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.lib()
    log(f"build: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    omap = scenario.build_map(MAP_CELLS, device=dev)
    scan = scenario.build_scan(N_BEAMS, device=dev)
    states = {r: scenario.build_filter(N_PARTICLES, pose_cov=cov, min_particles=N_PARTICLES,
                                       device=dev)
              for r, cov in REGIMES.items()}
    torch.cuda.synchronize()
    log(f"scenario: {N_PARTICLES} x {N_BEAMS} on {MAP_CELLS}^2 in "
        f"{time.perf_counter() - t0:.2f} s")

    kernels = phase_kernels(dev, omap, scan, states)
    launches = phase_main_path(dev, omap, scan, states)
    phase_reference(dev)
    timings = phase_timings(dev, omap, scan, states)

    meta = {
        "corr_table": ("badger_amcl_tpu_torch/csrc/corr_table.cu",
                       "badger_amcl_tpu/ops/corr_kernel.py:227"),
        "spread_term_sums": ("badger_amcl_tpu_torch/csrc/spread_term_sums.cu",
                             "badger_amcl_tpu/ops/spread_kernel.py:556"),
        "lf_distances": ("badger_amcl_tpu_torch/csrc/lf_distances.cu",
                         "badger_amcl_tpu/ops/lf_kernel.py:182"),
    }
    line = {"kernels": [
        {"name": k, "route": "cuda", "source": meta[k][0], "replaces": meta[k][1],
         "launches": launches[k], **kernels[k]} for k in meta]}
    log(json.dumps({"timings": timings}))
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Failure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        code = 1
    sys.exit(code)
