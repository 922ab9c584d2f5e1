#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

Builds the port's CUDA kernels from badger_amcl_tpu_torch/csrc and drives
both of the port's paths:

- 2D: holds the corr, spread and lf kernels against their plain PyTorch
  versions at the flagship shapes (50,000 particles x 720 beams on a
  1024^2 map at 0.05 m), drives the likelihood-field MCL step
  (`mcl_step_2d`, `sensor_resample_step`) in the steady, tracking and
  spread regimes plus the steady regime on the "lf" backend, and compares
  the step on the card with the CPU at 4096 x 360;
- 3D: builds the 20 x 20 x 1 m voxel scene at 0.05 m (401 x 401 x 21 EDT)
  and its 256-point cloud, holds the pc and pc_spread kernels against
  their plain versions, drives the point-cloud step (motion update ->
  `point_cloud_likelihood` -> `sensor_update` -> `resample`) for both
  cloud models in the steady (50k), tracking (10k) and spread (50k)
  regimes, and compares the step on the card with the CPU at 4096 x 128.

Each path's launch counters are set to 0 just before it is driven and
read just after; every regime must go through its kernel and leave a sane
filter state. Kernels, likelihoods and steps are timed with CUDA events.

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
# the 3D regimes of benchmarks/parity_tpu.py, with 10k x 256 the production
# 3D scale for tracking
PARTICLES_3D = {"steady": 50_000, "tracking": 10_000, "spread": 50_000}
MODELS_3D = ("likelihood_field", "likelihood_field_gompertz")
ODOM = ([0.1, 0.0, 0.02], [0.1, 0.0, 0.02], [0.1, 0.0, 0.02], [0.1] * 5)
ROOT = os.path.dirname(os.path.abspath(__file__))
# H100 SXM published peaks (the bound of a kernel is the larger of bytes
# over the memory rate and f32 operations over the non-tensor f32 rate)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


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


def bound(nbytes, ops):
    """Least time (ms) the card could take: the larger of the bytes over
    the memory rate and the f32 operations over the f32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def nvidia_smi_line():
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return proc.stdout.strip().splitlines()[0] if proc.stdout.strip() else proc.stderr.strip()


def to_device(x, dev):
    """A tensor, or a dataclass of tensors (maps, states, scans), on dev."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, torch.device):
        return torch.device(dev)
    if dataclasses.is_dataclass(x):
        return type(x)(**{f.name: to_device(getattr(x, f.name), dev)
                          for f in dataclasses.fields(x)})
    return x


# --- 2D --------------------------------------------------------------------


def corr_conv2d(ck, tex_pad, off, nu, t_n, org, n_beams, rows):
    """The corr table as one dense torch.nn.functional.conv2d: each yaw
    bin's taps scattered into a (kh, kw) weight, over the texture window the
    taps reach. Returns (call, window bytes, live taps)."""
    import torch
    import torch.nn.functional as F

    t_n = int(t_n)
    t_max = nu.shape[0]
    w, oj, oi = ck._unpack(off.reshape(t_max, n_beams))
    dev = tex_pad.device
    live = torch.arange(n_beams, device=dev)[None, :] < nu[:, None]
    live &= torch.arange(t_max, device=dev)[:, None] < t_n
    j_lo, j_hi = int(oj[live].min()), int(oj[live].max())
    i_lo, i_hi = int(oi[live].min()), int(oi[live].max())
    kh, kw = j_hi - j_lo + 1, i_hi - i_lo + 1
    tt = torch.arange(t_max, device=dev)[:, None].expand_as(w)[live]
    weight = torch.zeros((t_n, 1, kh, kw), dtype=torch.float32, device=dev)
    weight.index_put_((tt, torch.zeros_like(tt), oj[live] - j_lo, oi[live] - i_lo),
                      w[live].to(torch.float32), accumulate=True)
    r0, c0 = int(org[0]) + j_lo, int(org[1]) + i_lo
    inp = tex_pad[r0:r0 + rows + kh - 1, c0:c0 + ck.PWIN_C + kw - 1][None, None].contiguous()
    check(tuple(inp.shape[2:]) == (rows + kh - 1, ck.PWIN_C + kw - 1),
          "corr conv2d window leaves the padded texture")
    return (lambda: F.conv2d(inp, weight)), inp.numel() * 4, int(live.sum())


def phase_kernels(dev, omap, scan, states):
    """Each 2D kernel against its plain version at the flagship shapes."""
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
        conv, win_bytes, taps = corr_conv2d(ck, *args)
        t_n = int(pre["t_n"])
        lib_err = float((conv()[0] - got[:t_n]).abs().max())
        lib_ms = cuda_ms(conv)
        b = bound(got.numel() * 4 + taps * 4 + win_bytes, 2.0 * taps * rows * ck.PWIN_C)
        log(f"corr_table rows={rows} ({regime}): t_n={t_n} taps={taps} "
            f"max_abs_err={err:.3e} (table max {scale:.4g}) ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={b['bound_ms']:.5f} ({b['bound_by']}) conv2d_ms={lib_ms:.4f} "
            f"(conv2d max_abs_err {lib_err:.3e})")
        corr.append((rows, err, ms, plain_ms, lib_ms, b))
    rows32 = [c for c in corr if c[0] == 32][0]
    results["corr_table"] = dict(max_abs_err=max(c[1] for c in corr), ms=rows32[2],
                                 plain_ms=rows32[3], **rows32[5], library_ms=rows32[4])

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
    m, n_valid = spose.shape[0], int(valid.sum())
    # the wrapper reads the f32 distance field (it quantizes on every call);
    # 16 f32 operations per (particle, valid beam), exp counted as one
    b = bound(omap.distances.numel() * 4 + m * 16 + N_BEAMS * 9, 16.0 * m * n_valid)
    log(f"spread_term_sums (spread): max_abs_err={err:.3e} max_rel_err={rel:.3e} "
        f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b['bound_ms']:.5f} ({b['bound_by']})")
    results["spread_term_sums"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **b,
                                       library_ms=None)

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
        m = spose.shape[0]
        # 12 f32 operations per element (cos and sin counted as one each)
        b = bound(got.numel() * 4 + tex.numel() * tex.element_size() + m * 12 + N_BEAMS * 8,
                  12.0 * got.numel())
        log(f"lf_distances {str(dtype).split('.')[-1]} ({regime}): bit_equal={eq:.6f} "
            f"max_abs_err={err:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={b['bound_ms']:.5f} ({b['bound_by']})")
        lf.append((err, ms, plain_ms, b))
    results["lf_distances"] = dict(max_abs_err=max(x[0] for x in lf), ms=lf[0][1],
                                   plain_ms=lf[0][2], **lf[0][3], library_ms=None)
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


def pinned_step_fn(step_fn, state, n):
    """bench.py's pinned step: `step_fn(state)` (a full sensor update +
    resample), then the regime's cloud restored (perturbed by the output to
    keep a data dependency) so every iteration does the regime's work."""
    import torch

    poses0 = state.poses
    box = {"s": state, "out": None}

    def step():
        s2 = step_fn(box["s"])
        box["out"] = s2
        box["s"] = s2.replace(
            poses=poses0 + s2.poses.mean() * 1e-12,
            weights=torch.full_like(s2.weights, 1.0 / n),
            n_active=torch.full_like(s2.n_active, n))

    return step, box


class Launches:
    """Launch counts of a path's kernels: reset to 0 when the path starts,
    and the steps of each run in which a kernel launched."""

    def __init__(self, counters):
        self.counters = counters
        self.steps = dict.fromkeys(counters, 0)
        for fn in counters.values():
            fn.launches = 0

    def run(self, fn, n_steps):
        before = {k: c.launches for k, c in self.counters.items()}
        fn()
        rose = {k: c.launches - before[k] for k, c in self.counters.items()}
        for k, r in rose.items():
            if r > 0:
                self.steps[k] += n_steps
        return rose

    def read(self):
        return {k: dict(launches=c.launches,
                        launches_per_step=c.launches / max(self.steps[k], 1))
                for k, c in self.counters.items()}


def phase_main_path(dev, omap, scan, states):
    """Drive the 2D main path; returns the per-kernel launch counts of this
    run only."""
    import torch

    from badger_amcl_tpu_torch import mcl
    from badger_amcl_tpu_torch.ops import corr_kernel as ck
    from badger_amcl_tpu_torch.ops import lf_kernel as lk
    from badger_amcl_tpu_torch.ops import spread_kernel as sk
    from badger_amcl_tpu_torch.sensors.planar import PlanarScanParams

    expect = {"steady": "corr_table", "tracking": "corr_table",
              "spread": "spread_term_sums"}
    sp = PlanarScanParams()
    counts = Launches({"corr_table": ck.corr_table, "spread_term_sums": sk.spread_term_sums,
                       "lf_distances": lk.lf_distances})
    gen = torch.Generator(device=dev).manual_seed(1)
    for regime, backend in (("steady", "corr"), ("tracking", "corr"),
                            ("spread", "corr"), ("steady", "lf")):
        params, state, pool = states[regime]
        name = expect[regime] if backend == "corr" else "lf_distances"
        step, box = pinned_step_fn(
            lambda s: mcl.sensor_resample_step(s, omap, sp, scan, pool, params,
                                               backend=backend, generator=gen),
            state, params.max_samples)

        def run():
            s = state
            for _ in range(3):
                s = mcl.mcl_step_2d(s, omap, sp, scan, pool, *ODOM, params,
                                    backend=backend, generator=gen)
            check_state(s, params, f"{regime}/{backend} mcl_step_2d")
            for _ in range(3):
                step()
            torch.cuda.synchronize()

        rose = counts.run(run, 6)
        out = box["out"]
        check_state(out, params, f"{regime}/{backend} sensor_resample_step")
        check(rose[name] > 0, f"{regime}/{backend}: {name} was not launched")
        if regime == "steady":
            err = float(out.stats.mean[:2].norm())
            check(err < 0.1, f"steady/{backend}: mean {out.stats.mean.tolist()} "
                             f"is {err:.3f} m from the truth")
        log(f"main path {regime}/{backend}: {name} launches +{rose[name]}, n_active="
            f"{int(out.n_active)}, clusters={int(out.stats.cluster_count)}, "
            f"mean={[round(v, 4) for v in out.stats.mean.tolist()]}")
    return counts.read()


def phase_reference(dev):
    """The whole 2D step on the card (kernels) against the same step on the
    CPU (plain versions), same inputs and draws, at a small size."""
    import torch

    from badger_amcl_tpu_torch import mcl, scenario
    from badger_amcl_tpu_torch.sensors.planar import PlanarScanParams

    omap_c = scenario.build_map(448, device="cpu")
    scan_c = scenario.build_scan(360, device="cpu")
    params, state_c, pool_c = scenario.build_filter(
        4096, pose_cov=(0.02, 0.02, 0.002), min_particles=1024, device="cpu")
    noise_c = mcl.StepNoise.draw(torch.Generator().manual_seed(5), 4096, "cpu", odom=False)
    sp = PlanarScanParams()

    def to(x):
        return to_device(x, dev)

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


def device_busy(fn, steps=5, top=6):
    """(device ms, device ops, the `top` device ops by time as [name, ms])
    per call of fn: the summed kernel times of a torch.profiler window of
    `steps` calls, one stream, so no overlap."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    ev.sort(key=lambda e: -e.self_device_time_total)
    return (sum(e.self_device_time_total for e in ev) / steps / 1e3,
            sum(e.count for e in ev) / steps,
            [[e.key[:60], e.self_device_time_total / steps / 1e3] for e in ev[:top]])


def timing_row(key, like_fn, step):
    from badger_amcl_tpu_torch.utils.numerics import SYNCS

    like_ms = cuda_ms(like_fn)
    s0 = SYNCS.count
    step()
    syncs = SYNCS.count - s0
    step_ms = cuda_ms(step)
    busy_ms, ops, top_ops = device_busy(step)
    log(f"timing {key}: likelihood_ms={like_ms:.4f} step_ms={step_ms:.4f} "
        f"host_syncs_per_step={syncs} device_busy_ms={busy_ms:.4f} "
        f"device_ops_per_step={ops:.0f} idle_share={1.0 - busy_ms / step_ms:.3f}")
    log(f"timing {key}: top device ops (ms/step): "
        + "; ".join(f"{n} {t:.4f}" for n, t in top_ops))
    return dict(likelihood_ms=like_ms, step_ms=step_ms, host_syncs_per_step=syncs,
                device_busy_ms=busy_ms, device_ops_per_step=ops,
                device_idle_share=1.0 - busy_ms / step_ms, top_device_ops=top_ops)


def phase_timings(dev, omap, scan, states):
    import torch

    from badger_amcl_tpu_torch import mcl
    from badger_amcl_tpu_torch.sensors.planar import PlanarScanParams

    sp = PlanarScanParams()
    gen = torch.Generator(device=dev).manual_seed(2)
    out = {}
    for regime, backend in (("steady", "corr"), ("tracking", "corr"),
                            ("spread", "corr"), ("steady", "lf")):
        params, state, pool = states[regime]
        step, _ = pinned_step_fn(
            lambda s: mcl.sensor_resample_step(s, omap, sp, scan, pool, params,
                                               backend=backend, generator=gen),
            state, params.max_samples)
        key = regime if backend == "corr" else f"{regime}_{backend}"
        out[key] = timing_row(
            key, lambda: mcl.likelihood_only(state, omap, sp, scan, backend=backend), step)
    return out


# --- 3D --------------------------------------------------------------------


def step_3d(state, omap, pcp, cloud, pool, params, model, gen, motion=True, noise=None):
    """One point-cloud step as node_3d composes it: motion update, cloud
    likelihood, sensor update, KLD resample."""
    from badger_amcl_tpu_torch import mcl
    from badger_amcl_tpu_torch.pf import filter as pf_filter
    from badger_amcl_tpu_torch.sensors import odom
    from badger_amcl_tpu_torch.sensors.point_cloud import point_cloud_likelihood

    if noise is None:
        noise = mcl.StepNoise.draw(gen, params.max_samples, state.poses.device, odom=motion)
    if motion:
        state = odom.motion_update(state, odom.OdomModel.DIFF, ODOM[3], ODOM[0], ODOM[1],
                                   noise.odom, ODOM[2])
    p, mf = point_cloud_likelihood(omap, pcp, cloud, state.poses, model, backend="corr")
    state = pf_filter.sensor_update(state, p, mf)
    return pf_filter.resample(state, params, pool, noise.inject, noise.pick)


def phase_kernels_3d(omap, cloud, states):
    """Both 3D kernels against their plain versions at the main path's
    shapes."""
    import torch

    from badger_amcl_tpu_torch.ops import pc_kernel as pk
    from badger_amcl_tpu_torch.ops import pc_spread_kernel as psk
    from badger_amcl_tpu_torch.sensors import point_cloud as pc

    results = {}
    nx, ny, nz = omap.size
    tex_bytes = nx * ny * nz
    n_pts = cloud.shape[0]
    pcp = pc.PointCloudParams()

    rows = []
    for regime in ("steady", "tracking"):
        poses = states[regime][1].poses
        got = pk.pc_distances(omap, cloud, poses)
        want = pk.pc_distances_plain(omap, cloud, poses)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        eq = float((diff == 0).float().mean())
        err = float(diff.max())
        tol = omap.resolution * math.sqrt(2.0) + omap.max_distance_ratio
        check(eq >= 0.9999 and err <= tol,
              f"pc_distances ({regime}): {eq:.6f} bit-equal, max err {err} (tol {tol})")
        ms = cuda_ms(lambda: pk.pc_distances(omap, cloud, poses))
        plain_ms = cuda_ms(lambda: pk.pc_distances_plain(omap, cloud, poses))
        m = poses.shape[0]
        # 13 f32 operations per (point, particle), cos and sin per particle
        b = bound(got.numel() * 4 + tex_bytes + m * 12 + n_pts * 12,
                  13.0 * got.numel() + 2.0 * m)
        log(f"pc_distances ({regime}, {n_pts} x {m}): bit_equal={eq:.6f} "
            f"max_abs_err={err:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={b['bound_ms']:.5f} ({b['bound_by']})")
        rows.append((err, ms, plain_ms, b))
    results["pc_distances"] = dict(max_abs_err=max(r[0] for r in rows), ms=rows[0][1],
                                   plain_ms=rows[0][2], **rows[0][3], library_ms=None)

    rows = []
    for regime in ("spread", "tracking"):
        poses = states[regime][1].poses
        m = poses.shape[0]
        for model in MODELS_3D:
            term, _, _ = pc._model_term_finalize(omap, pcp, model, n_pts)
            got = psk.pc_spread_term_sums(omap, poses, cloud, term)
            inputs = psk.endpoint_inputs(omap, poses, cloud)
            want = psk.pc_spread_term_sums_plain(omap, *inputs, term)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            rel = float(((got - want).abs() / want.abs().clamp(min=1e-30)).max())
            check(rel <= 1e-5, f"pc_spread_term_sums ({regime}, {model}) rel err {rel} > 1e-5")
            ms = cuda_ms(lambda: psk.pc_spread_term_sums(omap, poses, cloud, term))
            plain_ms = cuda_ms(lambda: psk.pc_spread_term_sums_plain(omap, *inputs, term))
            # 17 f32 operations per pair with the cube (15 without), exp as one
            ops_pair = 17.0 if term.cube else 15.0
            b = bound(tex_bytes + m * 12 + n_pts * 12 + m * 4, ops_pair * m * n_pts)
            log(f"pc_spread_term_sums ({regime}, {model}, {n_pts} x {m}): "
                f"max_abs_err={err:.3e} max_rel_err={rel:.3e} ms={ms:.4f} "
                f"plain_ms={plain_ms:.4f} bound_ms={b['bound_ms']:.5f} ({b['bound_by']})")
            rows.append((err, ms, plain_ms, b))
    # reported: the spread cloud under the 3D default (Gompertz) model
    results["pc_spread_term_sums"] = dict(max_abs_err=max(r[0] for r in rows), ms=rows[1][1],
                                          plain_ms=rows[1][2], **rows[1][3], library_ms=None)
    return results


def phase_main_path_3d(dev, omap, cloud, states):
    """Drive the 3D path for both models in every regime; returns the
    per-kernel launch counts of this run only."""
    import torch

    from badger_amcl_tpu_torch.ops import pc_kernel as pk
    from badger_amcl_tpu_torch.ops import pc_spread_kernel as psk
    from badger_amcl_tpu_torch.scenario import TRUE_POSE_3D
    from badger_amcl_tpu_torch.sensors.point_cloud import PointCloudParams

    # the tracking cloud (cov 0.02) spans more than the windowed kernel's
    # 64-row window, so the JAX dispatch and the port send it to pc_spread
    expect = {"steady": "pc_distances", "tracking": "pc_spread_term_sums",
              "spread": "pc_spread_term_sums"}
    pcp = PointCloudParams()
    counts = Launches({"pc_distances": pk.pc_distances,
                       "pc_spread_term_sums": psk.pc_spread_term_sums})
    gen = torch.Generator(device=dev).manual_seed(3)
    for regime in PARTICLES_3D:
        params, state, pool = states[regime]
        for model in MODELS_3D:
            step, box = pinned_step_fn(
                lambda s: step_3d(s, omap, pcp, cloud, pool, params, model, gen,
                                  motion=False),
                state, params.max_samples)

            def run():
                s = state
                for _ in range(3):
                    s = step_3d(s, omap, pcp, cloud, pool, params, model, gen)
                check_state(s, params, f"3d {regime}/{model} step")
                for _ in range(3):
                    step()
                torch.cuda.synchronize()

            rose = counts.run(run, 6)
            out = box["out"]
            check_state(out, params, f"3d {regime}/{model} pinned step")
            name = expect[regime]
            check(rose[name] > 0, f"3d {regime}/{model}: {name} was not launched")
            mean = out.stats.mean.tolist()
            if regime == "steady":
                err = math.hypot(mean[0] - TRUE_POSE_3D[0], mean[1] - TRUE_POSE_3D[1])
                check(err < 0.1, f"3d steady/{model}: mean {mean} is {err:.3f} m from the truth")
            log(f"main path 3d {regime}/{model}: launches {rose}, n_active="
                f"{int(out.n_active)}, clusters={int(out.stats.cluster_count)}, "
                f"mean={[round(v, 4) for v in mean]}")
    return counts.read()


def phase_reference_3d(dev, omap):
    """The whole 3D step on the card (kernels) against the same step on the
    CPU (plain versions), same inputs and draws, at 4096 x 128, for both
    models on a windowed (steady) and a spread cloud."""
    import torch

    from badger_amcl_tpu_torch import mcl, scenario
    from badger_amcl_tpu_torch.ops import pc_kernel as pk
    from badger_amcl_tpu_torch.ops import pc_spread_kernel as psk
    from badger_amcl_tpu_torch.sensors.point_cloud import (
        PointCloudParams, point_cloud_likelihood,
    )

    omap_c = to_device(omap, "cpu")
    cloud_c = torch.as_tensor(scenario.scene_3d(128)[1])
    pcp = PointCloudParams()
    for regime, kernel in (("steady", pk.pc_distances),
                           ("spread", psk.pc_spread_term_sums)):
        params, state_c, pool_c = scenario.build_filter_3d(
            4096, 7, REGIMES[regime], 1024, device="cpu")
        noise_c = mcl.StepNoise.draw(torch.Generator().manual_seed(9), 4096, "cpu",
                                     odom=False)
        state_g = to_device(state_c, dev)
        for model in MODELS_3D:
            before = kernel.launches
            p_c, mf_c = point_cloud_likelihood(omap_c, pcp, cloud_c, state_c.poses, model,
                                               "corr")
            p_g, mf_g = point_cloud_likelihood(omap, pcp, cloud_c.to(dev), state_g.poses,
                                               model, "corr")
            check(kernel.launches > before, f"3d reference {regime}: kernel not launched")
            p_c, p_g = p_c * mf_c, (p_g * mf_g).cpu()
            close = ((p_g - p_c).abs() <= 1e-4 * p_c.abs()).float().mean().item()
            check(close >= 0.99, f"3d reference {regime}/{model}: only {close:.4f} of "
                                 "likelihoods agree to 1e-4")
            out_c = step_3d(state_c, omap_c, pcp, cloud_c, pool_c, params, model, None,
                            motion=False, noise=noise_c)
            out_g = step_3d(state_g, omap, pcp, cloud_c.to(dev), to_device(pool_c, dev),
                            params, model, None, motion=False, noise=to_device(noise_c, dev))
            same = (out_g.poses.cpu() == out_c.poses).all(dim=1).float().mean().item()
            dmean = float((out_g.stats.mean.cpu() - out_c.stats.mean)[:2].norm())
            check(int(out_g.n_active) == int(out_c.n_active),
                  f"3d reference {regime}/{model}: n_active differs")
            check(same >= 0.99 and dmean < 0.01, f"3d reference {regime}/{model}: picks "
                                                 f"equal {same:.4f}, mean diff {dmean:.4g} m")
            log(f"reference 3d {regime}/{model} (4096 x 128, card vs CPU): likelihoods "
                f"within 1e-4: {close:.4f}, picks equal: {same:.4f}, n_active "
                f"{int(out_g.n_active)}, mean diff {dmean:.3e} m")


def phase_timings_3d(dev, omap, cloud, states):
    import torch

    from badger_amcl_tpu_torch.sensors.point_cloud import (
        PointCloudParams, point_cloud_likelihood,
    )

    pcp = PointCloudParams()
    gen = torch.Generator(device=dev).manual_seed(4)
    out = {}
    for regime in PARTICLES_3D:
        params, state, pool = states[regime]
        for model in MODELS_3D:
            step, _ = pinned_step_fn(
                lambda s: step_3d(s, omap, pcp, cloud, pool, params, model, gen,
                                  motion=False),
                state, params.max_samples)
            key = f"3d_{regime}_{'gompertz' if model.endswith('gompertz') else 'lf'}"
            out[key] = timing_row(
                key, lambda: point_cloud_likelihood(omap, pcp, cloud, state.poses, model,
                                                    "corr"), step)
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
    log(f"build: {time.perf_counter() - t0:.2f} s ({len(_build.sources())} sources)")

    # 2D path
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
    del omap, scan, states

    # 3D path
    t0 = time.perf_counter()
    occ, cloud_np = scenario.scene_3d()
    omap3 = scenario.build_octomap(occ, device=dev)
    cloud = torch.as_tensor(cloud_np, device=dev)
    states3 = {r: scenario.build_filter_3d(n, pose_cov=REGIMES[r], min_particles=n,
                                           device=dev)
               for r, n in PARTICLES_3D.items()}
    torch.cuda.synchronize()
    log(f"scenario 3d: {omap3.size} voxels ({omap3.tex_zyx.numel() / 1e6:.2f} MB), "
        f"{cloud.shape[0]}-point cloud, {dict(PARTICLES_3D)} particles in "
        f"{time.perf_counter() - t0:.2f} s")
    kernels.update(phase_kernels_3d(omap3, cloud, states3))
    launches.update(phase_main_path_3d(dev, omap3, cloud, states3))
    phase_reference_3d(dev, omap3)
    timings.update(phase_timings_3d(dev, omap3, cloud, states3))

    meta = {
        "corr_table": ("badger_amcl_tpu_torch/csrc/corr_table.cu",
                       "badger_amcl_tpu/ops/corr_kernel.py:227"),
        "spread_term_sums": ("badger_amcl_tpu_torch/csrc/spread_term_sums.cu",
                             "badger_amcl_tpu/ops/spread_kernel.py:556"),
        "lf_distances": ("badger_amcl_tpu_torch/csrc/lf_distances.cu",
                         "badger_amcl_tpu/ops/lf_kernel.py:182"),
        "pc_distances": ("badger_amcl_tpu_torch/csrc/pc_distances.cu",
                         "badger_amcl_tpu/ops/pc_kernel.py:168"),
        "pc_spread_term_sums": ("badger_amcl_tpu_torch/csrc/pc_spread_term_sums.cu",
                                "badger_amcl_tpu/ops/pc_spread_kernel.py:490"),
    }
    line = {"kernels": [
        {"name": k, "route": "cuda", "source": meta[k][0], "replaces": meta[k][1],
         **launches[k], **kernels[k]} for k in meta]}
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
