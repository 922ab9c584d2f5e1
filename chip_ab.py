#!/usr/bin/env python3
"""Compare checkouts of the port on one CUDA card, in turns: the cells and
kernels that the single-robot corr tables (#1, #6), the spread term sums
(#3), the fleet table (#5), the beam lattice table (#7), the beam spread
sums (#8), the lf kernels (#4) with beam skipping and the 3D windowed (#9)
and spread (#10) kernels serve.

    python3 chip_ab.py OUT_DIR ROOT [ROOT ...]

Each ROOT is a checkout holding chip_smoke.py and badger_amcl_tpu_torch/;
each runs in a process of its own, in the order given (for two versions A
and B: A B B A), building its kernels under its own tree. Per run:
chip_smoke's timing rows (step_ms, likelihood_ms, device busy, idle share)
of the steady, tracking, q_steady, q_tracking, gompertz_steady,
prob_steady, spread, gompertz_spread, prob_spread, beam_steady,
beam_tracking, beam_spread, steady_lf, prob_beamskip, fleet and the
3d_steady, 3d_tracking and 3d_spread cells (both cloud models); the
wrapper ms, device ms and host us per call of corr_table and corr_table_q
(`corr_tables`); the wrapper and device ms of spread_term_sums (50,000 x
720, spread cloud, pz^3), beam_table (beam_steady's 24-row window),
beam_spread_sums (beam_spread's 50,000 particles), fleet_corr_table (256
robots x 10,000 x 180) and pc_spread_term_sums (the Gompertz term on the
50,000 spread and the 10,000 tracking 3D clouds), the device ms summed
over the ops of chip_smoke.kernel_ms (a ROOT must have it); where a ROOT
has the fused lf sums, theirs and the lf prepass's on the steady_lf
cloud; where it has beam skipping's counts, theirs on that cloud; where
it has the windowed arm's fused sums and prepass, theirs on the 50,000
steady 3D cloud (Gompertz) and the prepass's on all three 3D clouds.
Every run prints one JSON line, also appended to OUT_DIR/ab.jsonl, with
the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time


def device_ms(ops):
    """The summed ms of a chip_smoke.kernel_ms dict, or None when the
    profiler recorded no launch (kept here: an older ROOT's chip_smoke
    has no such helper)."""
    return sum(ops.values()) if ops else None


def host_us(fn, calls=1000):
    """Host microseconds per call of fn over `calls` calls with no
    synchronisation between them, after a warm-up (kept here: an older
    ROOT's chip_smoke has no such helper)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def corr_tables(cs, omap, scan, clouds):
    """Wrapper ms, device ms and host us per call of corr_table (the steady
    cloud's 24-row and the tracking cloud's 32-row window) and corr_table_q
    (both clouds' 32-row windows), at 50,000 x 720."""
    from badger_amcl_tpu_torch.ops import corr_kernel as ck
    from badger_amcl_tpu_torch.sensors import planar

    sp = planar.PlanarScanParams()
    out = {}
    for key, regime, rows, q in (("corr_table_steady24", "steady", 24, False),
                                 ("corr_table_tracking32", "tracking", 32, False),
                                 ("corr_table_q_steady32", "steady", 32, True),
                                 ("corr_table_q_tracking32", "tracking", 32, True)):
        spose = planar.coord_add(sp.scanner_pose, clouds[regime][1].poses)
        pre = ck.corr_prepass(omap, spose, scan.ranges, scan.angles, scan.valid(), dedup=True)
        j0 = pre["j0_tight"] if rows == 24 else pre["j0_narrow"]
        tex = omap.corr_psi_pad_q if q else omap.corr_psi_pad
        org = ck.table_origin(pre, j0, ck.PAD_RQ if q else ck.PAD_R)
        args = (tex, pre["off"], pre["nu"], pre["t_n"], org, cs.N_BEAMS, rows)
        fn = ck.corr_table_q if q else ck.corr_table

        def run():
            return fn(*args)

        out[key] = {"t_n": int(pre["t_n"]), "ms": cs.cuda_ms(run),
                    "device_ms": device_ms(cs.kernel_ms(run)), "host_us": host_us(run)}
    return out


def one(root):
    """Time one checkout; returns its result dict."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from badger_amcl_tpu_torch import scenario
    from badger_amcl_tpu_torch.fleet import fleet_window
    from badger_amcl_tpu_torch.ops import _build
    from badger_amcl_tpu_torch.ops import beam_kernel as bk
    from badger_amcl_tpu_torch.ops import beam_spread_kernel as bsk
    from badger_amcl_tpu_torch.ops import corr_kernel as ck
    from badger_amcl_tpu_torch.ops import lf_kernel as lk
    from badger_amcl_tpu_torch.ops import spread_kernel as sk
    from badger_amcl_tpu_torch.sensors import planar

    if not cs.__file__.startswith(os.path.abspath(root)):
        raise RuntimeError(f"chip_smoke imported from {cs.__file__}, not {root}")
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.lib()
    out = {"root": root, "device": torch.cuda.get_device_name(0), "smi": cs.nvidia_smi_line(),
           "build_s": time.perf_counter() - t0}
    sp = planar.PlanarScanParams()
    omap = scenario.build_map(cs.MAP_CELLS, device=dev)
    scan = scenario.build_scan(cs.N_BEAMS, device=dev)
    maps = {"likelihood_field": omap, "beam": omap.with_range_image(cs.RANGE_IMAGE_BINS),
            **{m: planar.bake_corr_texture(omap, sp, 8.0, m) for m in cs.LF_MODELS}}
    spread, steady, tracking, tracking50 = (
        scenario.build_filter(n, pose_cov=cs.REGIMES[r], min_particles=n, device=dev)
        for r, n in (("spread", cs.N_PARTICLES), ("steady", cs.N_PARTICLES),
                     ("tracking", 5_000), ("tracking", cs.N_PARTICLES)))
    states = {"spread": spread, "gompertz_spread": spread, "prob_spread": spread,
              "beam_steady": steady, "beam_tracking": tracking, "beam_spread": spread,
              "steady_lf": steady,
              "prob_beamskip": steady, "steady": steady, "tracking": tracking50,
              "q_steady": steady, "q_tracking": tracking50, "gompertz_steady": steady,
              "prob_steady": steady}
    out.update(corr_tables(cs, omap, scan, {"steady": steady, "tracking": tracking50}))

    spose = planar.coord_add(sp.scanner_pose, spread[1].poses)
    term = planar.model_term("likelihood_field", sp, scan.range_max)
    valid = scan.valid()

    def run_spread():
        return sk.spread_term_sums(omap, spose, scan.ranges, scan.angles, valid, term)

    out["spread_term_sums"] = {"ms": cs.cuda_ms(run_spread),
                               "device_ms": device_ms(cs.kernel_ms(run_spread))}

    bmap = maps["beam"]
    bpose = planar.coord_add(sp.scanner_pose, steady[1].poses)
    pre = bk.beam_prepass(bmap, bpose, scan.range_max)
    rows, j0 = ck.window_variant(pre, bool(pre["tight"]), bool(pre["narrow"]))
    bargs = (bmap.range_image, scan.ranges, scan.angles, pre["t_n"], pre["t_min"],
             pre["t_order"], bk.window_origin(pre, j0),
             bk.BeamMix.of(sp, scan.range_max, bmap.resolution), pre["dtheta"], rows)

    def run_beam():
        return bk.beam_table(*bargs)

    out["beam_table"] = {"rows": rows, "ms": cs.cuda_ms(run_beam),
                         "device_ms": device_ms(cs.kernel_ms(run_beam))}
    spre = bsk.beam_spread_prepass(bmap, spose, scan.angles)
    sargs = (bmap.range_rows, spre["flat"], spre["sig"], spre["gocc"], spre["n_g"],
             bsk.phi_tables(bmap, sp, scan, spre["kap"]), bsk.value_cap(bmap, scan.range_max))

    def run_beam_spread():
        return bsk.beam_spread_sums(*sargs)

    out["beam_spread_sums"] = {"ms": cs.cuda_ms(run_beam_spread),
                               "device_ms": device_ms(cs.kernel_ms(run_beam_spread))}
    if hasattr(lk, "lf_term_sums"):
        lpose = planar.coord_add(sp.scanner_pose, steady[1].poses)
        tex = lk.lf_texture(omap, lpose, scan.ranges, scan.angles)

        def run_sums():
            return lk.lf_term_sums(omap, tex, lpose, scan.ranges, scan.angles, valid, term)

        def run_prepass():
            return lk.window_origins(omap, lpose, scan.ranges, scan.angles)

        out["lf_term_sums"] = {"tex": str(tex.dtype), "ms": cs.cuda_ms(run_sums),
                               "device_ms": device_ms(cs.kernel_ms(run_sums))}
        out["lf_prepass"] = {"ms": cs.cuda_ms(run_prepass),
                             "device_ms": device_ms(cs.kernel_ms(run_prepass))}
        if hasattr(lk, "lf_obs_counts"):
            active = steady[1].active_mask

            def run_counts():
                return lk.lf_obs_counts(omap, tex, lpose, scan.ranges, scan.angles, valid,
                                        active, sp.beam_skip_distance)

            out["lf_obs_counts"] = {"tex": str(tex.dtype), "ms": cs.cuda_ms(run_counts),
                                    "device_ms": device_ms(cs.kernel_ms(run_counts))}

    gen = torch.Generator(device=dev).manual_seed(2)
    for key in states:
        c = cs.CELLS_2D[key]
        params, state, pool = cs.cell_state(key, states)
        step, _ = cs.pinned_step_fn(
            lambda s: cs.step_2d(s, maps[c.model], sp, scan, pool, params, c.model, c.backend,
                                 gen, motion=False, beamskip=c.beamskip),
            state, params.max_samples)
        out[key] = cs.timing_row(key, cs.likelihood_fn(c.model, maps[c.model], sp, scan, state,
                                                       c.backend, c.beamskip), step)
    del states, spread, steady, tracking, tracking50, maps, bmap, bargs, sargs
    torch.cuda.empty_cache()

    fl = scenario.build_fleet(cs.FLEET_ROBOTS, cs.FLEET_PARTICLES, cs.FLEET_BEAMS, device=dev)
    # the window of the flags read here (fleet_window returns them, or
    # the window itself in older checkouts)
    pre = fleet_window(omap, sp, fl[2], fl[1])[0]
    rows, j0 = ck.window_variant(pre, bool(pre["tight"].all()), bool(pre["narrow"].all()))
    args = (omap.corr_psi_pad, pre["off"], pre["nv"], pre["t_n"], ck.table_origin(pre, j0),
            cs.FLEET_BEAMS, rows)

    def run_fleet():
        return ck.fleet_corr_table(*args)

    out["fleet_corr_table"] = {"rows": rows, "ms": cs.cuda_ms(run_fleet),
                               "device_ms": device_ms(cs.kernel_ms(run_fleet, calls=5))}
    out["fleet"] = cs.phase_timings_fleet(dev, omap, fl)
    del fl, omap
    torch.cuda.empty_cache()
    out.update(one_3d(cs, dev))
    return out


def one_3d(cs, dev):
    """The 3d_steady, 3d_tracking and 3d_spread timing rows, #10's times
    and, where the ROOT has them, the windowed arm's fused sums' and
    prepass's."""
    import torch

    from badger_amcl_tpu_torch import scenario
    from badger_amcl_tpu_torch.ops import pc_kernel as pk
    from badger_amcl_tpu_torch.ops import pc_spread_kernel as psk
    from badger_amcl_tpu_torch.sensors import point_cloud as pc

    out = {}
    occ, cloud_np = scenario.scene_3d()
    omap3 = scenario.build_octomap(occ, device=dev)
    cloud = torch.as_tensor(cloud_np, device=dev)
    pcp = pc.PointCloudParams()
    gen = torch.Generator(device=dev).manual_seed(4)
    for regime in ("steady", "tracking", "spread"):
        n = cs.PARTICLES_3D[regime]
        params, state, pool = scenario.build_filter_3d(n, pose_cov=cs.REGIMES[regime],
                                                       min_particles=n, device=dev)
        term, _, _ = pc._model_term_finalize(omap3, pcp, "likelihood_field_gompertz",
                                             cloud.shape[0])

        def run_sums():
            return psk.pc_spread_term_sums(omap3, state.poses, cloud, term)

        def run_windowed():
            return pk.pc_term_sums(omap3, cloud, state.poses, term)

        def run_prepass():
            return pk.window_origins(omap3, cloud, state.poses)

        if regime != "steady":
            out[f"pc_spread_term_sums_{regime}"] = {
                "particles": n, "ms": cs.cuda_ms(run_sums),
                "device_ms": device_ms(cs.kernel_ms(run_sums))}
        if hasattr(pk, "pc_term_sums"):
            if regime == "steady":
                out["pc_term_sums_steady"] = {
                    "particles": n, "ms": cs.cuda_ms(run_windowed),
                    "device_ms": device_ms(cs.kernel_ms(run_windowed))}
            out[f"pc_extents_{regime}"] = {
                "particles": n, "ms": cs.cuda_ms(run_prepass),
                "device_ms": device_ms(cs.kernel_ms(
                    lambda: pk.pc_extents(omap3, cloud, state.poses)))}
        for model in cs.MODELS_3D:
            step, _ = cs.pinned_step_fn(
                lambda s: cs.step_3d(s, omap3, pcp, cloud, pool, params, model, gen,
                                     motion=False),
                state, params.max_samples)
            key = f"3d_{regime}_{'gompertz' if model.endswith('gompertz') else 'lf'}"
            out[key] = cs.timing_row(
                key, lambda: pc.point_cloud_likelihood(omap3, pcp, cloud, state.poses, model,
                                                       "corr"), step)
    return out


def main(argv):
    if len(argv) >= 3 and argv[1] == "--one":
        print("AB " + json.dumps(one(argv[2])), flush=True)
        return 0
    if len(argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    out_dir, roots = argv[1], argv[2:]
    os.makedirs(out_dir, exist_ok=True)
    code = 0
    for root in roots:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                               os.path.abspath(root)],
                              capture_output=True, text=True, cwd=os.path.abspath(root))
        lines = [ln[3:] for ln in proc.stdout.splitlines() if ln.startswith("AB ")]
        if proc.returncode != 0 or not lines:
            print(f"chip_ab: {root} failed ({proc.returncode}):\n{proc.stderr[-4000:]}",
                  file=sys.stderr)
            code = 1
            continue
        with open(os.path.join(out_dir, "ab.jsonl"), "a") as f:
            f.write(lines[-1] + "\n")
        res = json.loads(lines[-1])
        print(f"{root}: " + json.dumps(
            {k: ({kk: vv for kk, vv in v.items() if kk != "top_device_ops"}
                 if isinstance(v, dict) else v) for k, v in res.items()}), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main(sys.argv))
