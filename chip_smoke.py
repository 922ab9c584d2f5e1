#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

Builds the port's CUDA kernels from badger_amcl_tpu_torch/csrc and drives
the port's three paths:

- 2D likelihood field: holds the corr, spread and lf kernels against their
  plain PyTorch versions at the flagship shapes (50,000 particles x 720
  beams on a 1024^2 map at 0.05 m): the corr table also bit-equal to the
  tap-order sum at 24, 32 and 64 rows, at a window in the texture's corner
  and with every yaw bin live; the lf kernels' (B, M) distances, their
  fused term sums in the three term forms (rel 1e-5) and their window
  prepass (fits and origins against window_origins' plain version) and
  beam skipping's per-beam agreement counts (equal on every beam without an
  endpoint-cell flip) on the bf16 steady and the f32 spread cloud; drives
  the likelihood-field MCL step (`mcl_step_2d`, `sensor_resample_step`)
  in the steady, tracking and spread regimes plus the steady regime on the
  "lf" backend, and compares the step on the card with the CPU at 4096 x
  360;
- the compiled 2D step (`mcl.sensor_resample_step_jit`, `mcl_step_2d_jit`
  with the diff-drive model, `likelihood_only_jit`: a CUDA graph per
  static key, every branch of the dispatch tree a conditional node) in the
  steady, tracking, spread, steady_lf, gompertz_steady and gompertz_spread
  cells at 50,000 x 720: 10 chained steps equal to the eager step on the
  same variates (poses, weights, n_active, converged and the integer
  statistics bit for bit, the float statistics, float64 sums rounded to
  float32, within 1e-4), the same arms as the eager step (the compiled arms from
  device counters), 0 host syncs inside the compiled calls (replays under
  sync debug mode "error"), one capture a key, compiled and eager step_ms,
  device busy and idle share; the cluster-labelling kernel
  (`ops/cluster_kernel.cluster_labels`, csrc/cluster_labels.cu) equal to
  its plain version's sweeps on the steady cloud's small grid, the
  spread cloud's full grid and the fleet step's batched (robots x cells)
  grid, recorded as the fleet path hands it to the kernel; #1/#2, #3, #4
  and the labelling kernel must launch inside replays (path "2d_compiled"),
  and every path counts the labelling kernel's launches; the IF nodes of
  csrc/graph_cond.cu: 16 chained conds against the same adds without
  conds (replay ms per IF node, the handle kernel's device time); the
  grid arms (the KLD stop's prefix scan past MAX_UNIQUE_BINS, the wide
  statistics past MAX_FAST_CLUSTERS) inside replays: 10 chained replays of
  `sensor_resample_step_jit` on 50,000 poses spread over the map's free
  cells equal to the eager step, the device arm counters showing both
  arms;
- 2D beam, Gompertz and prob models: bakes the K = 256 range image of the
  1024^2 map on the card (and a 256^2 map on the card and the CPU, which
  must agree bit for bit), holds the beam_table kernel (bit-equal, at its
  24- and 64-row windows and with a 65,536-entry value table),
  beam_spread_sums (also at K = 252, its unaligned row path) and the
  spread kernel's three term forms against their plain versions, drives
  the beam model in its tracking (5,000),
  steady and spread (50,000) cells and the Gompertz and prob (log-space)
  models in the steady and spread regimes at 50,000 x 720, the prob model
  also with beam skipping on a converged steady cloud (prob_beamskip: the
  node's do_beamskip path, lf_obs_counts then lf_term_sums; the (B, M)
  lf_distances, which no main path launches, must not launch), and
  compares the card with the CPU at 4096 x 360 on a 448^2 map, the beam
  model also in its exact raycast arm (timed on the card at that size
  only);
- 2D int8 corr backend ("corr_q"): holds corr_table_q against its plain
  version at 50,000 x 720 (int32, bit-equal, also at the texture's corner
  and with every yaw bin live), drives the likelihood-field
  step on "corr_q" in the steady and tracking regimes and compares the
  card with the CPU at 4096 x 360;
- 2D cell-space resampling contract: `sensor_resample_step(
  resample_contract="cell")` on "corr" at 50,000 x 720 in the steady and
  tracking (likelihood field), Gompertz and prob (exp form) steady and
  spread cells: the arm each step took (steady: the cell arm; spread: the
  pick contract's step, equal to it on the same variates), u_count, #1's
  launches, the timing rows of the cell and the pick contract on the same
  state, a chi-square (p > 1e-3) of one steady cell step's per-cell picks
  against the cell masses, and the card against the CPU at 4096 x 360
  (>= 99.9% of picks equal, n_active equal); compiled
  (`sensor_resample_step_jit(resample_contract="cell")`, one cond
  "cells.ok"): 10 chained replays in each of the five cells equal to the
  eager cell step, the cell arm in every replay of the four tight cells
  and the pick step in the spread one (device counters = the eager
  arms), 0 host syncs, one capture a key, compiled and eager step_ms;
- fleet: holds fleet_corr_table against its plain version on 16 robots
  scattered over the 1024^2 map (one without a valid beam) and at the
  fleet's own shape, drives `fleet_init` and `fleet_step` at 256 robots x
  10,000 particles x 180 beams (3 steps, then 3 pinned steps; the fleet
  table must launch on every step), compares the card with the CPU at
  4 x 2048 x 60 and times the fleet step (robot-steps/s, host syncs per
  step at 16 and 256 robots); the compiled fleet step
  (`make_fleet_step`, one CUDA graph, its conds "fleet.fits",
  "fleet.window.*" and "cluster.fleet_u" conditional nodes) on the
  flagship fleet, the same with robot 0's cloud spread and every robot's
  cloud spread: 10 chained replays each equal to eager `fleet_step`,
  both arms of "fleet.fits" and of "cluster.fleet_u" inside replays, 0
  host syncs, one capture, #5, #3 and the labelling kernel inside
  replays, compiled and eager step_ms, the capture's seconds, graph
  nodes and memory; then the sharded fleet (`make_sharded_fleet_step`,
  each rank's step the compiled one; `fleet_health(group)`) at the same
  shape: one NCCL rank in this process (a file store in a temporary
  directory) must equal the one-process compiled step bit for bit over 3
  steps with motion and launch #5 inside each replay, its NCCL health
  equal the local one; two gloo ranks spawned on the one card
  (`--fleet-rank`; NCCL refuses two ranks on one device), 128 robots
  each, each capturing its own graph, must match their rows of the
  one-process run, launch #5 inside every step's replay and reduce the
  whole fleet's health, each under its own time limit; their step ms are
  two processes sharing one card;
- 3D: builds the 20 x 20 x 1 m voxel scene at 0.05 m (401 x 401 x 21 EDT)
  and its 256-point cloud, holds the windowed arm's kernels against their
  plain versions (the window prepass on the 50k steady, 10k tracking and
  50k spread clouds, its extents equal; the fused term sums, rel 1e-5,
  and the (B, M) distances, which no main path launches, on the steady
  and tracking clouds) and the pc_spread kernel (on the spread and the
  tracking cloud), drives the point-cloud step (motion update ->
  `point_cloud_likelihood` -> `sensor_update` -> `resample`) for both
  cloud models in the steady (50k), tracking (10k) and spread (50k)
  regimes (every regime runs the prepass, steady the fused sums), and
  compares the step on the card with the CPU at 4096 x 128;
- map set-up: the maps' distance fields (`ops/edt_kernel`, csrc/edt.cu)
  at the receipt of store-sized maps through the nodes' entry points: a
  seeded 2000 x 1200 ROS grid of a 100 x 60 m store at 0.05 m through
  `Node2D.map_msg_received` with examples/amcl_2d.yaml (4000 x 2400 at
  0.025 m, 0.36 m cap; each stage timed; the field bit-equal to the numpy
  `capped_distance_field` and the plain version) and a 2000 x 1200 x 50
  voxel store through `Node3D.octomap_msg_received` with
  examples/amcl_3d.yaml (0.3 m; the texture equal to the plain version
  and to a brute-force minimum on the card at 65,536 random voxels and one
  64 x 64 x 50 block); no port module but maps/edt.py may import the
  numpy EDT, so the receipts cannot reach it;
  kernel, plain, numpy and scipy times, bounds and peak device memory;
  then 3 steps of 50,000 particles on each store map above the texture
  gates (2D corr from the tracking and the spread covariance, 3D
  Gompertz from the tracking one): the arm each step took, step ms and
  device busy;
- the 2D node: `make_node` on the card at 50,000 particles x 720 beams,
  fed the flagship map as an OccupancyGrid message, a TransformBuffer
  (odom->base, static base->laser) and 30 scans raycast along a scripted
  path (0.25 m and 0.02 rad per scan): the published amcl_pose must end
  within 0.15 m and 0.1 rad of the truth, and #1 must launch; per scan it
  logs the scan_received wall ms (CUDA synchronised, after 3 warm-ups),
  host syncs, device busy and ops (torch.profiler), idle share and
  launches. Then global localization and a few scans (the arm taken), a
  saved pose loaded back where PyYAML is installed, the card node against
  a CPU node (both on corr, 4096 x 360, zero-noise odometry, no
  resample: >= 99.9% of weights to 1e-4, clouds and pose to 1e-4 m), and
  a few scans
  each of the beam, prob (log space, beam skipping), corr_q and
  systematic nodes;
- the 3D node: examples/amcl_3d.yaml loaded by the port's
  `cli.load_config`, `make_node` on the card at 50,000 particles x 256
  points, fed the 3D scene as an OctomapMsg whose binary .bt payload the
  port's `write_bt` wrote (the map's set-up timed stage by stage: write,
  read, the card EDT, which must equal its plain version and the numpy
  EDT and launch once in the node's receipt) and 30 clouds of fresh voxel
  centres of the map the .bt round trip rebuilt, around a scripted path:
  the pose within 0.3 m and 0.25 rad, #9's prepass and fused sums must
  launch; per scan the same figures as the 2D node. Then
  global localization (#10 must launch), the card node against a CPU node
  (both on corr, 4096 x 128, zero-noise odometry, no resample: every
  weight to 1e-4 but those of particles with an endpoint within 1e-4
  cells of a cell boundary, >= 99.9% of all; clouds and pose to 1e-4 m),
  the production config unchanged (1,000-10,000 particles x 128 points:
  the particle count after each resample) and a few scans of clouds by
  the scene's own rule (the arms taken);
- the command line: `cli.run` with examples/amcl_2d.yaml, `--sim`, 30
  steps on the card in a temporary directory: rc 0, the node's state on
  CUDA, the pose saved on exit, the pose within 0.3 m and 0.25 rad of the
  simulator's truth, its wall seconds and kernel launches; then #4's
  prepass, distances and fused sums against their plain versions on the
  node's own last scan, cloud and a uniform pool;
- the nodes' compiled helpers (the JAX nodes' seven jax.jit helpers as
  graph_jit entries, which every node above calls where its configuration
  lies inside the compiled slice): the flagship 2D node (50,000 x 720, 30
  tracking scans and 4 after global localization), the same node on
  corr_q, with the prob model in log space with and without beam
  skipping, and with the beam model and its range image baked (20
  tracking scans each from the tracking covariance, the prob and beam
  nodes 4 more after global localization), examples/amcl_2d.yaml
  unchanged on the CLI's map and stream (8,000 x 60, the pool's score
  rejection) and examples/amcl_3d.yaml at 50,000 x 256 on the scene, each
  beside an eager twin (same config, seed and stream, its helpers
  uncaptured): at every scan n_active and the particle poses equal and
  the published poses within 1e-4, the device arm counters equal to the
  twin's arms, every helper call held to sync debug mode "error" (no host
  read inside a replay), one capture per new key, no entry holding the
  old map after a second map receipt, #1, #3, #4 (sums, extents and
  counts), #6, #7, #8, #9, #10 and the labelling kernel launched inside
  replays; per twin the scan_received medians (update-only, resampling),
  host syncs, device busy and idle share, score rounds and ms per round,
  pose errors;
- the capped statistics (`stats_max_clusters` 128) compiled:
  `sensor_resample_step_jit` from the tracking and spread clouds and
  `mcl_step_2d_jit` at 50,000 x 720, 10 chained replays each equal to the
  eager step (the capped arms: "cluster.sorted", no fused KLD ranks), and
  a capped flagship 2D node beside its eager twin for 20 scans, equal at
  every scan;
- the compiled entries, bounded: the compiled 3D node
  (examples/amcl_3d.yaml, 50,000 particles) fed 40 clouds of seeded raw
  sizes in [200, 5000] (each decimated size a new key), reconfigured
  three times with new alphas, then dropped: per scan the live entries
  per helper (at or under utils.graph.MAX_ENTRIES), captures, capture
  seconds and memory_reserved; no entry keyed on a replaced
  configuration that no live node holds; after the drop no entry holding
  its map, the map freed,
  and memory_reserved after empty_cache within 5% of its value before the
  node was built.

The launch counters are set to 0 just before each main-path run and read
just after, and each path (2d_lf, 2d_beam, 2d_gompertz, 2d_prob, 2d_q,
2d_cells, 2d_cells_compiled, fleet, fleet_compiled, sharded_fleet (its
in-process rank), 3d, map_setup, node_2d, node_3d, cli, node_compiled,
capped) keeps
its own count; the compiled paths' launches (2d_compiled,
2d_cells_compiled, fleet_compiled, sharded_fleet, capped, and the nodes'
helpers on node_2d, node_3d, cli and node_compiled) happen inside graph
replays, where no host counter moves: each arm's device counter times the
launches captured in that arm, the rest once a replay. Every
cell must go through its kernel and leave a sane filter state. Kernels, likelihoods and steps are timed with CUDA events,
kernels also by their profiled device time, the corr tables' wrappers
also by their host time per call.

    python3 chip_smoke.py

(`python3 chip_smoke.py --fleet-rank RANK WORLD DIR` is one gloo rank of
the sharded-fleet phase, which spawns it.)

Prints progress lines, then a {"kernels": [...]} JSON line, the card's
name and power limit, and as its last line
{"ok": true, "device": {...}}. Exits nonzero, with no result line, when
CUDA is unavailable, the package is missing or any phase fails.
"""

from __future__ import annotations

import collections
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
LF_MODELS = ("likelihood_field_gompertz", "likelihood_field_prob")
Cell = collections.namedtuple("Cell", "path model particles cov backend kernel beamskip",
                              defaults=(False,))


def _cells_2d():
    """The 2D cells: key -> Cell(path, laser model, particles, pose cov,
    backend, the kernel its arm runs). The likelihood-field cells are
    bench.py's regimes (plus steady on the "lf" backend), the beam cells
    benchmarks/run_all.py:81-137 and the steady regime; Gompertz and prob
    run the steady and spread regimes, the int8 backend the steady and
    tracking ones; prob also the steady regime with beam skipping on a
    converged state (the node's do_beamskip path)."""
    cells = {r: Cell("2d_lf", "likelihood_field", N_PARTICLES, REGIMES[r], "corr", k)
             for r, k in (("steady", "corr_table"), ("tracking", "corr_table"),
                          ("spread", "spread_term_sums"))}
    cells["steady_lf"] = Cell("2d_lf", "likelihood_field", N_PARTICLES, REGIMES["steady"],
                              "lf", "lf_term_sums")
    for r, n, k in (("tracking", 5_000, "beam_table"), ("steady", N_PARTICLES, "beam_table"),
                    ("spread", N_PARTICLES, "beam_spread_sums")):
        cells[f"beam_{r}"] = Cell("2d_beam", "beam", n, REGIMES[r], "corr", k)
    for m in LF_MODELS:
        short = m.split("_")[-1]
        for r, k in (("steady", "corr_table"), ("spread", "spread_term_sums")):
            cells[f"{short}_{r}"] = Cell(f"2d_{short}", m, N_PARTICLES, REGIMES[r], "corr", k)
    cells["prob_beamskip"] = Cell("2d_prob", "likelihood_field_prob", N_PARTICLES,
                                  REGIMES["steady"], "corr", "lf_obs_counts", beamskip=True)
    for r in ("steady", "tracking"):
        cells[f"q_{r}"] = Cell("2d_q", "likelihood_field", N_PARTICLES, REGIMES[r], "corr_q",
                               "corr_table_q")
    return cells


CELLS_2D = _cells_2d()
RANGE_IMAGE_BINS = 256  # config.py:201 beam_range_image_bins
# the 3D regimes of benchmarks/parity_tpu.py, with 10k x 256 the production
# 3D scale for tracking
PARTICLES_3D = {"steady": 50_000, "tracking": 10_000, "spread": 50_000}
MODELS_3D = ("likelihood_field", "likelihood_field_gompertz")
ODOM = ([0.1, 0.0, 0.02], [0.1, 0.0, 0.02], [0.1, 0.0, 0.02], [0.1] * 5)
ROOT = os.path.dirname(os.path.abspath(__file__))
# the JAX fleet benchmark (benchmarks/run_all.py:260-309)
FLEET_ROBOTS, FLEET_PARTICLES, FLEET_BEAMS = 256, 10_000, 180
# H100 SXM published peaks (the bound of a kernel is the larger of bytes
# over the memory rate and f32 operations over the non-tensor f32 rate)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# the gather floors of the corr tables: L1 at ~30 TB/s over the 132 SMs,
# and the SM boost clock
L1_BYTES_PER_S = 30e12
SM_CLOCK_HZ = 1.98e9
# integer adds and minima: 64 INT32 lanes in each of the 132 SMs (NVIDIA's
# H100 architecture paper) at that clock, the rate behind 67 TFLOP/s
INT32_OPS_PER_S = 132 * 64 * SM_CLOCK_HZ
# the kernels held against their plain versions that no main path
# launches, each with the note the kernels line carries: the (B, M)
# distances, kept as the counterparts of the JAX package's functions
OFF_MAIN_PATH = {
    "lf_distances": "the (B, M) distances, the counterpart of the JAX package's "
                    "lf_distances_t; beam skipping, their last consumer, takes "
                    "lf_obs_counts and lf_term_sums",
    "pc_distances": "the (B, M) distances, the counterpart of the JAX package's "
                    "windowed_distances / pc_distances_t; the windowed arm takes "
                    "pc_extents and pc_term_sums",
}


_T0 = time.perf_counter()


def log(msg):
    """A progress line, prefixed by the seconds since the script started."""
    print(f"[{time.perf_counter() - _T0:6.1f} s] {msg}", flush=True)


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


def bound(nbytes, ops, ops_per_s=F32_OPS_PER_S):
    """Least time (ms) the card could take: the larger of the bytes over
    the memory rate and the operations over their type's rate (f32 unless
    given)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
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
        if x.dtype == torch.uint16:  # copied through its int16 bit view
            return x.view(torch.int16).to(dev).view(torch.uint16)
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


def table_in_order(ck, tex, off, nu, t_n, org, n_beams, rows):
    """_table_in_order for one robot's table arguments."""
    return ck._table_in_order(tex, off[None], nu[None], t_n.reshape(1), org[None], n_beams,
                              rows)[0]


def all_bins_live(ck, tex, off, nu, t_n, org, n_beams, rows):
    """The table arguments with every one of the T_MAX bins live: bin t
    takes the taps and tap count of live bin t mod t_n."""
    import torch

    src = torch.arange(ck.T_MAX, device=off.device) % t_n
    off_all = off.reshape(ck.T_MAX, n_beams)[src].reshape(-1)
    return (tex, off_all, nu[src], torch.full_like(t_n, ck.T_MAX), org, n_beams, rows)


def clamped_windows(ck, tex, off, nu, t_n, org, n_beams, rows):
    """The table arguments with the window at the texture's two far corners,
    (0, 0) and (hp - rows, wp - PWIN_C), over a random texture of the same
    shape and type (the padded texture is constant there): the taps leave
    the texture, so the kernel's clamped loop runs. [(label, args)]."""
    import torch

    g = torch.Generator(device=tex.device).manual_seed(5)
    if tex.dtype == torch.int8:
        rand = torch.randint(-127, 128, tex.shape, generator=g, device=tex.device,
                             dtype=torch.int8)
    else:
        rand = torch.rand(tex.shape, generator=g, device=tex.device)
    hp, wp = tex.shape
    return [(f"window at the texture's corner {tuple(o)}",
             (rand, off, nu, t_n, torch.tensor(o, dtype=torch.int32, device=org.device),
              n_beams, rows))
            for o in ((0, 0), (hp - rows, wp - ck.PWIN_C))]


def gather_floor_ms(pairs, texel_bytes):
    """The floor of a gather that reads one texel per (tap, cell) `pairs`
    times from L1: 4-byte texels at ~30 TB/s over the card's SMs; 1-byte
    texels by load instructions, one L1 wavefront per warp load (32
    texels) on each SM at the 1.98 GHz boost clock."""
    import torch

    if texel_bytes == 4:
        return pairs * 4.0 / L1_BYTES_PER_S * 1e3
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return pairs / 32.0 / sms / SM_CLOCK_HZ * 1e3


def host_us(fn, calls=1000):
    """Host microseconds per call of fn: time.perf_counter over `calls`
    calls with no synchronisation between them, after a warm-up (the
    wrapper's dispatch; the card runs behind it)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


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
    # narrow, tracking cloud in the standard window): within 1e-5 of the
    # plain version and bit-equal to the tap-order sum
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
        in_order = table_in_order(ck, *args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        check(err <= 1e-5 * scale, f"corr_table[{rows}] err {err} > 1e-5 x {scale}")
        check(torch.equal(got, in_order), f"corr_table[{rows}] differs from _table_in_order in "
                                          f"{int((got != in_order).sum())} cells")
        ms = cuda_ms(lambda: ck.corr_table(*args))
        ops = kernel_ms(lambda: ck.corr_table(*args))
        us = host_us(lambda: ck.corr_table(*args))
        plain_ms = cuda_ms(lambda: ck.corr_table_plain(*args))
        conv, win_bytes, taps = corr_conv2d(ck, *args)
        t_n = int(pre["t_n"])
        lib_err = float((conv()[0] - got[:t_n]).abs().max())
        lib_ms = cuda_ms(conv)
        # the t_n live bins written once (the zero bins past t_n are read by
        # nothing), the taps and the window read once
        b = bound(t_n * rows * ck.PWIN_C * 4 + taps * 4 + win_bytes,
                  2.0 * taps * rows * ck.PWIN_C)
        floor = gather_floor_ms(taps * rows * ck.PWIN_C, 4)
        log(f"corr_table rows={rows} ({regime}): t_n={t_n} taps={taps} "
            f"max_abs_err={err:.3e} (table max {scale:.4g}), bit-equal to _table_in_order, "
            f"ms={ms:.4f} (wrapper) device_ms={device_text(ops)} host_us={us:.2f} "
            f"plain_ms={plain_ms:.4f} bound_ms={b['bound_ms']:.5f} ({b['bound_by']}) "
            f"gather_floor_ms={floor:.5f} conv2d_ms={lib_ms:.4f} "
            f"(conv2d max_abs_err {lib_err:.3e})")
        corr.append((rows, err, ms, plain_ms, lib_ms, b, device_ms(ops), us))
    # the kernel's clamped arm (the tracking window at the texture's
    # corners, its taps leaving the texture) and every bin live
    for label, cargs in (*clamped_windows(ck, *args),
                         (f"all {ck.T_MAX} bins live", all_bins_live(ck, *args))):
        got = ck.corr_table(*cargs)
        want = ck.corr_table_plain(*cargs)
        in_order = table_in_order(ck, *cargs)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        check(err <= 1e-5 * scale, f"corr_table ({label}) err {err} > 1e-5 x {scale}")
        check(torch.equal(got, in_order), f"corr_table ({label}) differs from _table_in_order")
        log(f"corr_table rows={args[-1]} (tracking, {label}): max_abs_err={err:.3e}, "
            f"bit-equal to _table_in_order")
    rows32 = [c for c in corr if c[0] == 32][0]
    results["corr_table"] = dict(max_abs_err=max(c[1] for c in corr), ms=rows32[2],
                                 device_ms=rows32[6], host_us=rows32[7], plain_ms=rows32[3],
                                 **rows32[5], library_ms=rows32[4])

    # spread_term_sums in the spread regime, in its three term forms (the
    # row reports the likelihood-field form); the CUDA prepass against the
    # torch endpoint inputs, the baked texture against a fresh one
    spose = planar.coord_add(sp.scanner_pose, states["spread"][1].poses)
    inputs = sk.endpoint_inputs(omap, spose, scan.ranges, scan.angles)
    qtex = sk.quantized_tex(omap)
    check(torch.equal(omap.distances_q, qtex), "the baked spread texture differs")
    prep = sk.endpoint_inputs_cuda(omap, spose, scan.ranges, scan.angles)
    for k, name in enumerate(("pxc", "pyc", "ct", "st", "rca", "rsa")):
        check(torch.equal(prep[k], inputs[k]), f"spread prepass: {name} differs from torch")
    m, n_valid = spose.shape[0], int(valid.sum())
    # the bytes each call must move: poses in, sums out, the scan, the
    # baked int8 texture and the 257-entry term table; 12 operations per
    # (particle, valid beam): the endpoint (8), two floors, the lookup, the add
    b = bound(m * 16 + N_BEAMS * 9 + qtex.numel() + 257 * 4, 12.0 * m * n_valid)
    for model in planar.CORR_MODELS:
        term = planar.model_term(model, sp, scan.range_max)
        run = (lambda t=term: sk.spread_term_sums(omap, spose, scan.ranges, scan.angles, valid,
                                                  t))
        got = run()
        want = sk.spread_term_sums_plain(omap, qtex, *inputs, valid, term)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = float(((got - want).abs() / want.abs().clamp(min=1e-30)).max())
        check(rel <= 1e-5, f"spread_term_sums ({term.form}) rel err {rel} > 1e-5")
        ms = cuda_ms(run)
        plain_ms = cuda_ms(lambda: sk.spread_term_sums_plain(omap, qtex, *inputs, valid,
                                                             term))
        # the device ops of one wrapper call (prepass and sums), profiled
        ops = kernel_ms(run)
        log(f"spread_term_sums (spread, {term.form}, {model}): max_abs_err={err:.3e} "
            f"max_rel_err={rel:.3e} ms={ms:.4f} (wrapper) device_ms={device_text(ops)} "
            f"({'; '.join(f'{n} {t:.4f}' for n, t in ops.items())}) plain_ms={plain_ms:.4f} "
            f"bound_ms={b['bound_ms']:.5f} ({b['bound_by']})")
        if term.form == "cube":
            results["spread_term_sums"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, **b, library_ms=None)

    results.update(phase_kernels_lf(omap, scan, states))
    return results


def phase_kernels_lf(omap, scan, states):
    """The lf kernels on the bf16 steady cloud and the f32 spread cloud:
    the (B, M) distances, the window prepass (extents, then fits and
    origins against window_origins' plain version), beam skipping's
    agreement counts and the fused term sums in their three forms, each
    against its plain version."""
    import torch

    from badger_amcl_tpu_torch.ops import lf_kernel as lk
    from badger_amcl_tpu_torch.sensors import planar

    sp = planar.PlanarScanParams()
    valid = scan.valid()
    n_valid = int(valid.sum())
    check(torch.equal(omap.distances_bf16, omap.distances.to(torch.bfloat16)),
          "the baked bf16 texture differs from the distance field in bf16")
    lf, sums, counts, pre = [], [], [], []
    for regime, tex in (("steady", omap.distances_bf16), ("spread", omap.distances)):
        dtype = str(tex.dtype).split(".")[-1]
        spose = planar.coord_add(sp.scanner_pose, states[regime][1].poses)
        args = (omap, tex, spose, scan.ranges, scan.angles)
        got = lk.lf_distances(*args)
        want = lk.lf_distances_plain(*args)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        eq = float((diff == 0).float().mean())
        err = float(diff.max())
        tol = omap.resolution * math.sqrt(2.0) + (2.0 ** -7 if dtype == "bfloat16" else 0.0)
        check(eq >= 0.9999 and err <= tol,
              f"lf_distances {dtype}: {eq:.6f} bit-equal, max err {err} (tol {tol})")
        # beams on which the kernel's endpoint cells differ from the plain
        # version's somewhere (a last-ulp cos/sin flip)
        flip_beams = set((diff > 0).any(dim=1).nonzero().flatten().tolist())
        del diff, want
        ms = cuda_ms(lambda: lk.lf_distances(*args))
        dev_ms = device_text(kernel_ms(lambda: lk.lf_distances(*args)))
        plain_ms = cuda_ms(lambda: lk.lf_distances_plain(*args), iters=5, warmup=1)
        m = spose.shape[0]
        # 12 f32 operations per element (cos and sin counted as one each)
        b = bound(got.numel() * 4 + tex.numel() * tex.element_size() + m * 12 + N_BEAMS * 8,
                  12.0 * got.numel())
        del got
        log(f"lf_distances {dtype} ({regime}): bit_equal={eq:.6f} max_abs_err={err:.3e} "
            f"ms={ms:.4f} device_ms={dev_ms} plain_ms={plain_ms:.4f} "
            f"bound_ms={b['bound_ms']:.5f} ({b['bound_by']})")
        lf.append((err, ms, plain_ms, b))

        # the window prepass: extents on the card against the plain version,
        # then fits / row0 / col0 against window_origins' plain version
        ext = lk.beam_extents(omap, spose, scan.ranges, scan.angles)
        ext_plain = lk.beam_extents_plain(omap, spose, scan.ranges, scan.angles)
        r0, c0, fits = lk.window_finish(omap, ext)
        r0_p, c0_p, fits_p = lk.window_finish(omap, ext_plain)
        torch.cuda.synchronize()
        check(bool(fits) == bool(fits_p), f"lf prepass ({regime}): fits {bool(fits)} != "
                                          f"window_origins' {bool(fits_p)}")
        check(bool(fits) == (regime == "steady"), f"lf prepass ({regime}): fits {bool(fits)}")
        odd = ((ext != ext_plain).any(dim=0) | (r0 != r0_p) | (c0 != c0_p)).nonzero()
        odd = odd.flatten().tolist()
        check(set(odd) <= flip_beams, f"lf prepass ({regime}): beams {odd} differ from "
                                      f"window_origins where lf_distances agrees")
        for k in odd:
            log(f"lf prepass ({regime}): beam {k} extents {ext[:, k].tolist()} vs plain "
                f"{ext_plain[:, k].tolist()} (a beam with a cell flip in lf_distances)")

        def prepass():
            return lk.window_finish(omap, lk.beam_extents(omap, spose, scan.ranges,
                                                          scan.angles))

        pre_ms = cuda_ms(prepass)
        pre_dev = kernel_ms(lambda: lk.beam_extents(omap, spose, scan.ranges, scan.angles))
        pre_plain_ms = cuda_ms(lambda: lk.window_finish(
            omap, lk.beam_extents_plain(omap, spose, scan.ranges, scan.angles)),
            iters=5, warmup=1)
        # 16 operations per (particle, beam): the endpoint (12) and 4 min/max
        pre_b = bound(m * 12 + N_BEAMS * 8 + 16 * N_BEAMS, 16.0 * m * N_BEAMS)
        pre.append((int((ext.long() - ext_plain.long()).abs().max()), pre_ms, pre_plain_ms,
                    pre_b, device_ms(pre_dev)))
        log(f"lf prepass ({regime}): fits={bool(fits)} beams differing from window_origins "
            f"{len(odd)} ms={pre_ms:.4f} (extents + finish) device_ms={device_text(pre_dev)} "
            f"({'; '.join(f'{n} {t:.4f}' for n, t in pre_dev.items())}) "
            f"plain_ms={pre_plain_ms:.4f} bound_ms={pre_b['bound_ms']:.5f} "
            f"({pre_b['bound_by']})")

        # beam skipping's agreement counts: equal on every beam whose
        # endpoint cells agree with the plain version's
        active = states[regime][1].active_mask
        n_active = int(active.sum())
        oargs = (*args, valid, active, sp.beam_skip_distance)
        obs = lk.lf_obs_counts(*oargs)
        obs_p = lk.lf_obs_counts_plain(*oargs)
        torch.cuda.synchronize()
        odd = (obs != obs_p).nonzero().flatten().tolist()
        check(set(odd) <= flip_beams, f"lf_obs_counts ({regime}): beams {odd} differ from "
                                      f"the plain counts where lf_distances agrees")
        frac = obs.float() / max(n_active, 1)
        frac_p = obs_p.float() / max(n_active, 1)
        masks = ((frac > sp.beam_skip_threshold) != (frac_p > sp.beam_skip_threshold))
        for k in odd:
            log(f"lf_obs_counts ({regime}): beam {k} count {int(obs[k])} vs plain "
                f"{int(obs_p[k])} (a beam with a cell flip in lf_distances)")
        for k in masks.nonzero().flatten().tolist():
            log(f"lf_obs_counts ({regime}): beam {k}'s skip mask differs from the plain one")
        obs_err = int((obs - obs_p).abs().max())
        obs_ms = cuda_ms(lambda: lk.lf_obs_counts(*oargs))
        obs_dev = kernel_ms(lambda: lk.lf_obs_counts(*oargs))
        obs_plain_ms = cuda_ms(lambda: lk.lf_obs_counts_plain(*oargs), iters=5, warmup=1)
        # as the prepass: 16 operations per (active particle, valid beam)
        obs_b = bound(m * 13 + N_BEAMS * 9 + tex.numel() * tex.element_size() + N_BEAMS * 4,
                      16.0 * n_active * n_valid)
        log(f"lf_obs_counts {dtype} ({regime}): beams differing {len(odd)}, skip masks "
            f"differing {int(masks.sum())}, max_abs_err={obs_err} ms={obs_ms:.4f} (wrapper) "
            f"device_ms={device_text(obs_dev)} "
            f"({'; '.join(f'{n} {t:.4f}' for n, t in obs_dev.items())}) "
            f"plain_ms={obs_plain_ms:.4f} bound_ms={obs_b['bound_ms']:.5f} "
            f"({obs_b['bound_by']})")
        counts.append((obs_err, obs_ms, obs_plain_ms, obs_b, device_ms(obs_dev)))

        # fused term sums in the three forms: ~21 operations per (particle,
        # valid beam), the endpoint (12), the term (8), the add; beside it
        # the (B, M) form's bound
        b_sum = bound(m * 12 + N_BEAMS * 9 + tex.numel() * tex.element_size() + m * 4,
                      21.0 * m * n_valid)
        for model in planar.CORR_MODELS:
            term = planar.model_term(model, sp, scan.range_max)
            sargs = (*args, valid, term)
            got = lk.lf_term_sums(*sargs)
            want = lk.lf_term_sums_plain(*sargs)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            rel = float(((got - want).abs() / want.abs().clamp(min=1e-30)).max())
            check(rel <= 1e-5, f"lf_term_sums ({regime}, {term.form}) rel err {rel} > 1e-5")
            ms = cuda_ms(lambda: lk.lf_term_sums(*sargs))
            ops = kernel_ms(lambda: lk.lf_term_sums(*sargs))
            plain_ms = cuda_ms(lambda: lk.lf_term_sums_plain(*sargs), iters=5, warmup=1)
            log(f"lf_term_sums {dtype} ({regime}, {term.form}, {model}): max_abs_err={err:.3e} "
                f"max_rel_err={rel:.3e} ms={ms:.4f} (wrapper) device_ms={device_text(ops)} "
                f"plain_ms={plain_ms:.4f} bound_ms={b_sum['bound_ms']:.5f} "
                f"({b_sum['bound_by']}; the (B, M) form's {b['bound_ms']:.5f}, "
                f"{b['bound_by']})")
            sums.append((regime, term.form, err, ms, plain_ms, b_sum))
    steady = [x for x in sums if x[:2] == ("steady", "cube")][0]
    return {"lf_distances": dict(max_abs_err=max(x[0] for x in lf), ms=lf[0][1],
                                 plain_ms=lf[0][2], **lf[0][3], library_ms=None),
            "lf_term_sums": dict(max_abs_err=max(x[2] for x in sums), ms=steady[3],
                                 plain_ms=steady[4], **steady[5], library_ms=None),
            "lf_extents": dict(max_abs_err=max(x[0] for x in pre), ms=pre[0][1],
                               device_ms=pre[0][4], plain_ms=pre[0][2], **pre[0][3],
                               library_ms=None),
            "lf_obs_counts": dict(max_abs_err=max(x[0] for x in counts), ms=counts[0][1],
                                  device_ms=counts[0][4], plain_ms=counts[0][2],
                                  **counts[0][3], library_ms=None)}


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
    """Launch counts of a path's kernels over its main-path runs: each run
    sets every count to 0 just before it and reads them just after, so a
    launch outside a run (a comparison, a diagnostic) is never counted.
    With `graphs` (graph_jit wrappers whose `.kernels` name the counters),
    the launches inside their replays during a run count too: each arm's
    captured launches times its device counter's rise, the rest once a
    replay (`replayed` keeps those apart)."""

    def __init__(self, counters, graphs=()):
        self.counters = counters
        self.graphs = tuple(graphs)
        self.launches = dict.fromkeys(counters, 0)
        self.steps = dict.fromkeys(counters, 0)
        self.replayed = collections.Counter()

    def _replay_state(self):
        """{graph: ({id: (entry, replays, arm counts)} of its live entries,
        held so that no entry captured in a run takes one's id; the
        launches of its dropped entries' replays so far)}."""
        return {g: ({id(e): (e, e.replays, e.capture.slot_counts()) for e in g.entries.values()},
                    collections.Counter(g.dropped_launches)) for g in self.graphs}

    def run(self, fn, n_steps):
        for c in self.counters.values():
            c.launches = 0
        before = self._replay_state()
        fn()
        rose = {k: c.launches for k, c in self.counters.items()}
        for g, (live0, dropped0) in before.items():
            replayed = collections.Counter(g.dropped_launches)
            replayed.subtract(dropped0)  # the replays of the entries dropped in the run ...
            live = {id(e): e for e in g.entries.values()}
            for i, (e, replays0, arms0) in live0.items():
                if i not in live:  # ... less those before it
                    replayed.subtract(e.capture.replay_launches(replays0, arms0))
            for i, e in live.items():
                _, replays0, arms0 = live0.get(i, (e, 0, []))
                arms = [n - (arms0[j] if j < len(arms0) else 0)
                        for j, n in enumerate(e.capture.slot_counts())]
                replayed.update(e.capture.replay_launches(e.replays - replays0, arms))
            for k, n in replayed.items():
                if k in rose and n:
                    rose[k] += n
                    self.replayed[k] += n
        for k, r in rose.items():
            self.launches[k] += r
            if r > 0:
                self.steps[k] += n_steps
        return rose

    def read(self):
        """{kernel: (launches, steps of the runs in which it launched)}."""
        return {k: (self.launches[k], self.steps[k]) for k in self.counters}


def node_graphs():
    """{"module.name": helper} of the nodes' graph_jit helpers (the JAX
    nodes' seven jax.jit helpers)."""
    from badger_amcl_tpu_torch.node import node, node_2d, node_3d

    mods = {"node": node, "node_2d": node_2d, "node_3d": node_3d}
    return {f"{m}.{name}": getattr(mods[m], name)
            for m, names in NODE_HELPERS.items() for name in names}


def counters_3d():
    """{name in the kernels line: wrapper} of every kernel a 3D step may
    launch."""
    from badger_amcl_tpu_torch.ops import cluster_kernel as clk
    from badger_amcl_tpu_torch.ops import pc_kernel as pk
    from badger_amcl_tpu_torch.ops import pc_spread_kernel as psk

    return {"cluster_labels": clk.cluster_labels, "pc_term_sums": pk.pc_term_sums,
            "pc_extents": pk.pc_extents, "pc_distances": pk.pc_distances,
            "pc_spread_term_sums": psk.pc_spread_term_sums}


def counters_2d():
    """{name in the kernels line: wrapper} of every kernel a 2D step may
    launch."""
    from badger_amcl_tpu_torch.ops import beam_kernel as bk
    from badger_amcl_tpu_torch.ops import beam_spread_kernel as bsk
    from badger_amcl_tpu_torch.ops import cluster_kernel as clk
    from badger_amcl_tpu_torch.ops import corr_kernel as ck
    from badger_amcl_tpu_torch.ops import lf_kernel as lk
    from badger_amcl_tpu_torch.ops import spread_kernel as sk

    return {"corr_table": ck.corr_table, "spread_term_sums": sk.spread_term_sums,
            "cluster_labels": clk.cluster_labels,
            "lf_distances": lk.lf_distances, "lf_term_sums": lk.lf_term_sums,
            "lf_extents": lk.beam_extents, "lf_obs_counts": lk.lf_obs_counts,
            "beam_table": bk.beam_table,
            "beam_spread_sums": bsk.beam_spread_sums, "corr_table_q": ck.corr_table_q}


def launch_counts(paths):
    """Per kernel, from {path: Launches.read()}: its launches over every
    path's main-path runs, launches per step, and each path's own count."""
    out = {}
    for path, read in paths.items():
        for k, (n, steps) in read.items():
            e = out.setdefault(k, {"launches": 0, "steps": 0, "launches_by_path": {}})
            if n > 0:
                e["launches"] += n
                e["steps"] += steps
                e["launches_by_path"][path] = {"launches": n, "launches_per_step": n / steps}
    return {k: {"launches": e["launches"],
                "launches_per_step": e["launches"] / max(e["steps"], 1),
                "launches_by_path": e["launches_by_path"]} for k, e in out.items()}


def step_2d(state, omap, sp, scan, pool, params, model, backend, gen, motion=True,
            noise=None, beamskip=False):
    """One 2D step through the port's entry points: `mcl_step_2d`, or
    `sensor_resample_step` without the motion update. The prob model runs
    the log-space pipeline as node_2d.py:39-56 composes it:
    `sensor_update_2d(log_space=True)` (with beam skipping where
    `beamskip`), then a resample over log-domain averages."""
    from badger_amcl_tpu_torch import mcl
    from badger_amcl_tpu_torch.pf import filter as pf_filter
    from badger_amcl_tpu_torch.sensors import odom

    if model != "likelihood_field_prob":
        if motion:
            return mcl.mcl_step_2d(state, omap, sp, scan, pool, *ODOM, params,
                                   laser_model=model, backend=backend, noise=noise,
                                   generator=gen)
        return mcl.sensor_resample_step(state, omap, sp, scan, pool, params,
                                        laser_model=model, backend=backend, noise=noise,
                                        generator=gen)
    if noise is None:
        noise = mcl.StepNoise.draw(gen, state.poses.shape[0], state.poses.device, odom=motion)
    if motion:
        state = odom.motion_update(state, odom.OdomModel.DIFF, ODOM[3], ODOM[0], ODOM[1],
                                   noise.odom, ODOM[2])
    state = mcl.sensor_update_2d(state, omap, sp, scan, model, do_beamskip=beamskip,
                                 backend=backend, log_space=True)
    return pf_filter.resample(state, params, pool, noise.inject, noise.pick,
                              log_averages=True)


def likelihood_fn(model, omap, sp, scan, state, backend="corr", beamskip=False):
    """The particle x beam likelihood alone, with its map factor; the prob
    model's as log p (log space), its factor added in log."""
    from badger_amcl_tpu_torch.sensors.planar import planar_likelihood

    log_space = model == "likelihood_field_prob"

    def like():
        p, mf = planar_likelihood(omap, sp, scan, state.poses, state.active_mask,
                                  state.n_active, model, converged=state.converged,
                                  do_beamskip=beamskip, backend=backend, fold_factors=True,
                                  prob_log_space=log_space)
        return p if mf is None else (p + mf.log() if log_space else p * mf)

    return like


def cell_state(cell, states):
    """A cell's (params, state, pool); the prob model's with log-domain
    averages, the beam-skipping cell's converged."""
    import torch

    from badger_amcl_tpu_torch.pf import filter as pf_filter

    params, state, pool = states[cell]
    c = CELLS_2D[cell]
    if c.model == "likelihood_field_prob":
        state = pf_filter.init_log_averages(state)
    if c.beamskip:
        state = state.replace(converged=torch.ones_like(state.converged))
    return params, state, pool


def phase_main_path(dev, maps, scan, states):
    """Drive every 2D cell through `mcl_step_2d` and the pinned
    `sensor_resample_step` (the prob model through their log-space
    composition); returns each path's launch counts of this run only."""
    import torch

    from badger_amcl_tpu_torch import mcl
    from badger_amcl_tpu_torch.sensors import planar

    sp = planar.PlanarScanParams()
    counters = counters_2d()
    paths = {}
    gen = torch.Generator(device=dev).manual_seed(1)
    for key, c in CELLS_2D.items():
        counts = paths.setdefault(c.path, Launches(counters))
        omap = maps[c.model]
        params, state, pool = cell_state(key, states)
        step, box = pinned_step_fn(
            lambda s: step_2d(s, omap, sp, scan, pool, params, c.model, c.backend, gen,
                              motion=False, beamskip=c.beamskip),
            state, params.max_samples)

        def run():
            s = state
            if c.beamskip:
                # the node's entry point with beam skipping, in its exp form
                s1 = mcl.mcl_step_2d(s, omap, sp, scan, pool, *ODOM, params,
                                     laser_model=c.model, do_beamskip=True,
                                     backend=c.backend, generator=gen)
                check_state(s1, params, f"{key} mcl_step_2d(do_beamskip=True)")
            for _ in range(3):
                s = step_2d(s, omap, sp, scan, pool, params, c.model, c.backend, gen,
                            beamskip=c.beamskip)
            check_state(s, params, f"{key} mcl_step_2d")
            for _ in range(3):
                step()
            torch.cuda.synchronize()

        rose = counts.run(run, 7 if c.beamskip else 6)
        out = box["out"]
        check_state(out, params, f"{key} sensor_resample_step")
        check(rose[c.kernel] > 0, f"{key}: {c.kernel} was not launched")
        if c.backend == "lf":
            check(rose["lf_extents"] > 0, f"{key}: the lf window prepass was not launched")
        if c.beamskip:
            # beam skipping: the counts, then the fused sums; nothing (B, M)
            check(rose["lf_term_sums"] > 0, f"{key}: lf_term_sums was not launched")
            check(rose["lf_distances"] == 0,
                  f"{key}: the (B, M) lf_distances launched {rose['lf_distances']} times")
        if key in ("steady", "steady_lf", "beam_steady", "q_steady"):
            err = float(out.stats.mean[:2].norm())
            check(err < 0.1, f"{key}: mean {out.stats.mean.tolist()} is {err:.3f} m from "
                             "the truth")
        extra = ""
        if c.model == "likelihood_field_prob":
            # outside the counted run: the log-space update keeps what the
            # exp form loses (at 720 beams exp(sum log pz) underflows f32);
            # from LOG_UNINIT a finite w_slow means a finite total: no reset
            upd = mcl.sensor_update_2d(state, omap, sp, scan, c.model, backend="corr",
                                       log_space=True)
            check(bool(torch.isfinite(upd.w_slow)),
                  f"{key}: the log-space update found a zero total")
            p_exp, _ = planar.planar_likelihood(omap, sp, scan, state.poses,
                                                state.active_mask, state.n_active, c.model,
                                                backend="corr")
            extra = (f", log w_avg {float(upd.w_slow):.4f}, exp-form p underflowed to 0 "
                     f"for {float((p_exp == 0).float().mean()):.4f} of particles")
        log(f"main path {key} ({c.path}, {c.model}/{c.backend}): launches "
            f"{ {k: r for k, r in rose.items() if r} }, n_active={int(out.n_active)}, "
            f"clusters={int(out.stats.cluster_count)}, "
            f"mean={[round(v, 4) for v in out.stats.mean.tolist()]}{extra}")
    return {path: counts.read() for path, counts in paths.items()}


def phase_reference(dev):
    """Every 2D model's step on the card (kernels) against the same step on
    the CPU (plain versions), same inputs and draws, at 4096 x 360 on a
    448^2 map whose range image is baked on the card: the likelihood field
    in the tracking regime, the beam, Gompertz and prob (log-space) models
    in the steady and spread regimes, the likelihood field on "corr_q" in
    the tracking regime, the prob model with beam skipping on a converged
    steady cloud, and the beam model's exact raycast arm (the map without
    its range image), timed on the card at this size only."""
    import dataclasses

    import torch

    from badger_amcl_tpu_torch import mcl, scenario
    from badger_amcl_tpu_torch.ops import beam_kernel as bk
    from badger_amcl_tpu_torch.ops import beam_spread_kernel as bsk
    from badger_amcl_tpu_torch.ops import corr_kernel as ck
    from badger_amcl_tpu_torch.ops import lf_kernel as lk
    from badger_amcl_tpu_torch.pf import filter as pf_filter
    from badger_amcl_tpu_torch.sensors import planar

    sp = planar.PlanarScanParams()
    omap_g = scenario.build_map(448, device=dev, range_image_bins=RANGE_IMAGE_BINS)
    plain_g = dataclasses.replace(omap_g, range_image=None, range_rows=None)
    maps_g = {"likelihood_field": plain_g, "likelihood_field_q": plain_g, "beam": omap_g,
              "beam_exact": plain_g,
              **{m: planar.bake_corr_texture(plain_g, sp, 8.0, m) for m in LF_MODELS}}
    maps_g["prob_beamskip"] = maps_g["likelihood_field_prob"]
    maps_c = {m: to_device(x, "cpu") for m, x in maps_g.items()}
    scan_c = scenario.build_scan(360, device="cpu")
    kernels = {("likelihood_field", "tracking"): ck.corr_table,
               ("likelihood_field_q", "tracking"): ck.corr_table_q,
               ("beam", "steady"): bk.beam_table, ("beam", "spread"): bsk.beam_spread_sums,
               ("prob_beamskip", "steady"): lk.lf_obs_counts}
    rows = [("likelihood_field", "tracking"), ("likelihood_field_q", "tracking")]
    rows += [(label, r) for label in ("beam", "beam_exact", *LF_MODELS)
             for r in ("steady", "spread")]
    rows += [("prob_beamskip", "steady")]
    for label, regime in rows:
        model = {"beam_exact": "beam", "likelihood_field_q": "likelihood_field",
                 "prob_beamskip": "likelihood_field_prob"}.get(label, label)
        backend = "corr_q" if label.endswith("_q") else "corr"
        skip = label == "prob_beamskip"
        kernel = kernels.get((label, regime),
                             ck.corr_table if regime == "steady" else lk.lf_term_sums)
        params, state_c, pool_c = scenario.build_filter(
            4096, pose_cov=REGIMES[regime], min_particles=1024, device="cpu")
        if model == "likelihood_field_prob":
            state_c = pf_filter.init_log_averages(state_c)
        if skip:
            state_c = state_c.replace(converged=torch.ones_like(state_c.converged))
        noise_c = mcl.StepNoise.draw(torch.Generator().manual_seed(7), 4096, "cpu",
                                     odom=False)
        state_g = to_device(state_c, dev)
        scan_g = to_device(scan_c, dev)
        before = {k: k.launches for k in (bk.beam_table, bsk.beam_spread_sums, kernel)}
        p_c = likelihood_fn(model, maps_c[label], sp, scan_c, state_c, backend, skip)()
        like_g = likelihood_fn(model, maps_g[label], sp, scan_g, state_g, backend, skip)
        p_g = like_g().cpu()
        exact_ms = None
        if label == "beam_exact":
            check(all(k.launches == n for k, n in before.items()),
                  f"reference {label}/{regime}: a kernel ran in the exact arm")
            exact_ms = cuda_ms(like_g, iters=5, warmup=1)
        else:
            check(kernel.launches > before[kernel],
                  f"reference {label}/{regime}: kernel not launched")
        close = ((p_g - p_c).abs() <= 1e-4 * p_c.abs()).float().mean().item()
        check(close >= 0.99, f"reference {label}/{regime}: only {close:.4f} of "
                             "likelihoods agree to 1e-4")
        out_c, out_g = (
            step_2d(st, maps[label], sp, to_device(scan_c, d), to_device(pool_c, d), params,
                    model, backend, None, motion=False, noise=to_device(noise_c, d),
                    beamskip=skip)
            for st, maps, d in ((state_c, maps_c, "cpu"), (state_g, maps_g, dev)))
        same = (out_g.poses.cpu() == out_c.poses).all(dim=1).float().mean().item()
        dmean = float((out_g.stats.mean.cpu() - out_c.stats.mean)[:2].norm())
        check(int(out_g.n_active) == int(out_c.n_active),
              f"reference {label}/{regime}: n_active differs")
        check(same >= 0.99 and dmean < 0.01, f"reference {label}/{regime}: picks equal "
                                             f"{same:.4f}, mean diff {dmean:.4g} m")
        arm = (f"exact raycast, likelihood_ms on the card {exact_ms:.4f}" if exact_ms
               else kernel.__name__)
        log(f"reference {label}/{regime} (4096 x 360 on 448^2, card vs CPU, {arm}): "
            f"likelihoods within 1e-4: {close:.4f}, picks equal: {same:.4f}, n_active "
            f"{int(out_g.n_active)}, mean diff {dmean:.3e} m")


def kernel_ms(fn, calls=10):
    """{device op name: ms per launch} of fn over a torch.profiler window
    of `calls` calls, after one warm-up call: each op's time over the
    launches the profiler recorded (it can drop some), so a wrapper that
    launches each op once per call sums to its device ms per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key[:48]: e.self_device_time_total / e.count / 1e3 for e in prof.key_averages()
            if e.device_type.name == "CUDA" and e.self_device_time_total > 0}


def device_ms(ops):
    """The summed ms of a kernel_ms dict, or None when the profiler
    recorded no launch (the kernels line then carries no number)."""
    return sum(ops.values()) if ops else None


def device_text(ops):
    """device_ms as text for the log: "not measured" when the profiler
    recorded no launch."""
    return f"{device_ms(ops):.4f}" if ops else "not measured (no launch recorded)"


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


def phase_timings(dev, maps, scan, states):
    import torch

    from badger_amcl_tpu_torch.sensors.planar import PlanarScanParams

    sp = PlanarScanParams()
    gen = torch.Generator(device=dev).manual_seed(2)
    out = {}
    for key, c in CELLS_2D.items():
        omap = maps[c.model]
        params, state, pool = cell_state(key, states)
        step, _ = pinned_step_fn(
            lambda s: step_2d(s, omap, sp, scan, pool, params, c.model, c.backend, gen,
                              motion=False, beamskip=c.beamskip),
            state, params.max_samples)
        out[key] = timing_row(key, likelihood_fn(c.model, omap, sp, scan, state, c.backend,
                                                 c.beamskip), step)
    return out


# --- the compiled 2D step ----------------------------------------------------

# the cells of the compiled step's slice, and the chained steps that hold
# it against the eager step
COMPILED_CELLS = ("steady", "tracking", "spread", "steady_lf", "gompertz_steady",
                  "gompertz_spread")
COMPILED_CHAIN = 10
# the statistics' segment sums are a float64 index_add_ rounded to float32
# (its atomics add in no fixed order, so a sum near a float32 rounding
# boundary may round either way), so the float statistics are held to the
# card-vs-CPU checks' 1e-4 (the node reference's weights and poses) as a
# relative and an absolute tolerance, everything else bit for bit
STATS_TOL = 1e-4


def cluster_grids(states):
    """The cluster kernel's inputs on the main path: the SMALL_GRID
    occupancy of the steady cloud's bins (the sorted path's recode) and the
    full histogram grid of the spread cloud."""
    import torch

    from badger_amcl_tpu_torch.pf import cluster, kld

    params, state, _ = states["steady"]
    keys = kld.bin_keys(state.poses)
    rel = keys - keys.min(0).values + 1
    gsx, gsy, gsa = cluster.SMALL_GRID
    check(bool((rel.max(0).values <= torch.tensor([gsx - 2, gsy - 2, gsa - 2],
                                                  device=rel.device)).all()),
          "the steady cloud does not fit the small grid")
    occ_s = torch.zeros((gsx * gsy * gsa,), dtype=torch.bool, device=keys.device)
    occ_s[((rel[:, 2] * gsx + rel[:, 0]) * gsy + rel[:, 1]).long()] = True
    params, state, _ = states["spread"]
    ones = torch.ones_like(state.weights, dtype=torch.bool)
    _, flat = kld.grid_cells(kld.bin_keys(state.poses), ones, params.hist_shape)
    return {"small (steady)": (occ_s, cluster.SMALL_GRID),
            "full (spread)": (kld.occupancy_grid(flat, ones, params.hist_shape),
                              params.hist_shape)}


def fleet_cluster_grids(dev, omap, fl):
    """The occupancy grids the fleet step hands the cluster kernel: one
    fleet step from the fleet's state, each call's grid recorded (the
    batched (R, n_cells) grid of `pf.cluster._ranks_fleet`)."""
    import torch

    from badger_amcl_tpu_torch.pf import cluster

    seen, kernel = [], cluster.cluster_labels

    def record(occ, shape):
        seen.append((occ.clone(), shape))
        return kernel(occ, shape)

    gen = torch.Generator(device=dev).manual_seed(17)
    cluster.cluster_labels = record
    try:
        fleet_step_fn(fl, omap, gen)(fl[1])
    finally:
        cluster.cluster_labels = kernel
    batched = [(occ, shape) for occ, shape in seen if occ.dim() == 2]
    check(len(batched) > 0, "the fleet step handed the cluster kernel no batched grid")
    return {f"fleet {tuple(occ.shape)}": (occ, shape) for occ, shape in batched}


def phase_kernels_cluster(grids):
    """cluster_labels against its plain version (the box-min sweeps to
    their fixpoint, on the card) on each of `grids` ({label: (occupancy,
    grid shape)}): equal labels. Returns {label: row}."""
    import torch

    from badger_amcl_tpu_torch.ops import cluster_kernel as clk

    rows = {}
    for label, (occ, shape) in grids.items():
        got = clk.cluster_labels(occ, shape)
        want = clk.cluster_labels_plain(occ, shape)
        err = int((got - want).abs().max())
        check(err == 0, f"cluster_labels ({label}) differs from the sweeps in "
                        f"{int((got != want).sum())} cells")
        ms = cuda_ms(lambda: clk.cluster_labels(occ, shape))
        ops = kernel_ms(lambda: clk.cluster_labels(occ, shape))
        plain_ms = cuda_ms(lambda: clk.cluster_labels_plain(occ, shape), iters=5, warmup=1)
        n = occ.numel()
        # the occupancy read and the labels written once
        b = bound(5 * n, 0)
        cell = torch.arange(occ.shape[-1], device=occ.device, dtype=got.dtype)
        log(f"cluster_labels {label}: {n} cells, {int(occ.sum())} occupied, "
            f"{int((occ & (got == cell)).sum())} components; equal to the sweeps; "
            f"ms={ms:.4f} (wrapper) "
            f"device_ms={device_text(ops)} "
            f"({'; '.join(f'{k} {t:.4f}' for k, t in ops.items())}) plain_ms={plain_ms:.4f} "
            f"bound_ms={b['bound_ms']:.6f} ({b['bound_by']})")
        rows[label] = dict(max_abs_err=err, ms=ms, device_ms=device_ms(ops), plain_ms=plain_ms,
                           **b, library_ms=None)
    return rows


GRAPH_COND_CONDS = 16  # 32 IF nodes of the 64 a capture holds


def phase_graph_cond(dev):
    """The IF nodes of csrc/graph_cond.cu: a graph_jit of GRAPH_COND_CONDS
    chained conds on one float (each arm one add; every predicate true)
    against a graph_jit of the same adds without conds. Equal to the eager
    function; the replays' ms (CUDA events over `graph.replay()`), their
    difference per IF node, and the handle kernel's device time per launch
    (torch.profiler). Then its WHILE node: a GRAPH_COND_CONDS-iteration
    `control.fori_loop` equal to the Python loop, its body run that often.
    Returns the figures."""
    import torch

    from badger_amcl_tpu_torch.utils import control
    from badger_amcl_tpu_torch.utils.graph import graph_jit

    k = GRAPH_COND_CONDS

    def conds(x):
        for i in range(k):
            x = control.cond(x[0] > i - 0.5, lambda v: v + 1.0, lambda v: v - 0.5, x,
                             name=f"probe{i}")
        return x

    def adds(x):
        for _ in range(k):
            x = x + 1.0
        return x

    with_if, without = graph_jit(conds, ()), graph_jit(adds, ())
    x = torch.zeros((1,), device=dev)
    want = conds(x)
    got = with_if(x)
    check(torch.equal(got, want) and torch.equal(without(x), want),
          f"graph_cond: the compiled conds give {got.tolist()}, eager {want.tolist()}")
    entry = next(iter(with_if.entries.values()))
    plain = next(iter(without.entries.values()))
    n_if = len(entry.capture.slots)
    check(n_if == 2 * k, f"graph_cond: {n_if} IF nodes for {k} conds")
    rep_if, rep_plain = cuda_ms(entry.graph.replay, iters=200), cuda_ms(plain.graph.replay,
                                                                        iters=200)
    ops = kernel_ms(entry.graph.replay, calls=20)
    handle = {n: t for n, t in ops.items() if "set_if_handle" in n}
    arms = entry.capture.arm_counts()
    out = dict(conds=k, if_nodes=n_if, replay_ms=rep_if, replay_ms_without_conds=rep_plain,
               ms_per_if_node=(rep_if - rep_plain) / n_if,
               handle_kernel_device_ms=device_ms(handle), arms_true=sum(
                   v for a, v in arms.items() if a.endswith(":true")), max_abs_err=0.0)
    log(f"graph_cond: {k} chained conds ({n_if} IF nodes, one handle kernel each) equal to "
        f"the eager conds; replay {rep_if:.4f} ms vs {rep_plain:.4f} ms for the same {k} adds "
        f"without conds: {1e3 * out['ms_per_if_node']:.2f} us per IF node; the handle "
        f"kernel's device time per launch {device_text(handle)} ms (torch.profiler; ops "
        + "; ".join(f"{n} {t:.4f}" for n, t in ops.items()) + ")")

    # the WHILE node of control.fori_loop: k iterations of a body that adds
    # row i of a table, captured once, against the Python loop
    def loop(x, table):
        return control.fori_loop(k, lambda i, v: v + (table[i] if isinstance(i, int) else
                                                      table.index_select(0, i.reshape(1))),
                                 x, name="probe_loop")

    table = torch.arange(k, dtype=torch.float32, device=dev) + 0.25
    looped = graph_jit(loop, ())
    got, want = looped(x, table), loop(x, table)
    lentry = next(iter(looped.entries.values()))
    n_body = lentry.capture.arm_counts().get("probe_loop:body", 0)
    check(torch.equal(got, want) and n_body == k,
          f"graph_cond: the compiled loop gives {got.tolist()} in {n_body} body runs, "
          f"eager {want.tolist()} in {k}")
    out.update(loop_iterations=k, loop_graph_nodes=lentry.nodes,
               loop_replay_ms=cuda_ms(lentry.graph.replay, iters=200))
    log(f"graph_cond: a {k}-iteration fori_loop (one WHILE node, its body captured once, "
        f"{lentry.nodes} graph nodes) equal to the Python loop; replay "
        f"{out['loop_replay_ms']:.4f} ms")
    return out


def compiled_steps(omap, sp, scan, pool, params, model, backend):
    """{path: (eager step, compiled step)}, each (state, noise) -> state:
    `sensor_resample_step` and `mcl_step_2d` with the diff-drive model."""
    import torch

    from badger_amcl_tpu_torch import mcl

    kw = dict(laser_model=model, backend=backend)
    # the odometry as device tensors, as a compiled step takes it
    odom = [torch.tensor(v, dtype=torch.float32, device=pool.device) for v in ODOM[:3]]
    return {
        "sensor_resample_step": tuple(
            (lambda s, nz, f=f: f(s, omap, sp, scan, pool, params, noise=nz, **kw))
            for f in (mcl.sensor_resample_step, mcl.sensor_resample_step_jit)),
        "mcl_step_2d": tuple(
            (lambda s, nz, f=f: f(s, omap, sp, scan, pool, *odom, ODOM[3], params, noise=nz,
                                  **kw))
            for f in (mcl.mcl_step_2d, mcl.mcl_step_2d_jit)),
    }


def graph_arms(graph):
    """{arm: executions} over every key of a compiled entry point's graph
    wrapper (one host read a key)."""
    out = collections.Counter()
    for entry in graph.entries.values():
        out.update(entry.capture.arm_counts())
    return out


def compare_chain(label, eager, compiled):
    """The eager and the compiled chain, step by step: poses, weights,
    n_active, converged and the integer statistics bit for bit, the float
    statistics within STATS_TOL (relative and absolute); returns the largest
    difference of each float statistic."""
    import torch

    worst = collections.Counter()
    for k, (e, c) in enumerate(zip(eager, compiled)):
        for name in ("poses", "weights", "n_active", "converged"):
            check(torch.equal(getattr(e, name), getattr(c, name)),
                  f"{label} step {k}: {name} differs from the eager step")
        for name in ("cluster_count", "cluster_counts", "cluster_valid", "particle_cluster"):
            check(torch.equal(getattr(e.stats, name), getattr(c.stats, name)),
                  f"{label} step {k}: stats.{name} differs from the eager step")
        for name in ("mean", "cov", "cluster_weights", "cluster_means", "cluster_covs"):
            a, b = getattr(e.stats, name), getattr(c.stats, name)
            worst[name] = max(worst[name], float((a - b).abs().max()))
            check(torch.allclose(a, b, rtol=STATS_TOL, atol=STATS_TOL),
                  f"{label} step {k}: stats.{name} differs by {worst[name]:.3e}, beyond rtol "
                  f"and atol {STATS_TOL}")
    return dict(worst)


def phase_compiled(dev, maps, scan, states, smi):
    """The compiled step (`sensor_resample_step_jit`, `mcl_step_2d_jit`,
    `likelihood_only_jit`) in the COMPILED_CELLS at 50k x 720: per cell and
    path, COMPILED_CHAIN chained steps against the eager step on the same
    variates (compare_chain), the arms taken (device counters against the
    eager step's), 0 host syncs inside the compiled calls (SYNCS, and the
    replays under torch.cuda.set_sync_debug_mode("error")), one capture a
    key, then compiled and eager step_ms (pinned step, CUDA events), device
    busy, ops and idle share. Returns the compiled path's launches (from
    the device arm counters and the launches captured in each arm) and the
    timing rows."""
    import torch

    from badger_amcl_tpu_torch import mcl
    from badger_amcl_tpu_torch.sensors.planar import PlanarScanParams

    sp = PlanarScanParams()
    graphs = {"sensor_resample_step": mcl.sensor_resample_step_jit.graph,
              "mcl_step_2d": mcl.mcl_step_2d_jit.graph}
    for graph in (*graphs.values(), mcl.likelihood_only_jit.graph):
        # the kernels whose launches each capture attributes to its arms
        graph.kernels.update(counters_2d())
    rows, keyed = {}, set()
    for key in COMPILED_CELLS:
        c = CELLS_2D[key]
        omap = maps[c.model]
        params, state, pool = cell_state(key, states)
        m = params.max_samples
        gen = torch.Generator(device=dev).manual_seed(11)
        for path, (eager_fn, jit_fn) in compiled_steps(omap, sp, scan, pool, params, c.model,
                                                        c.backend).items():
            label = f"compiled {key}/{path}"
            motion = path == "mcl_step_2d"
            noises = [mcl.StepNoise.draw(gen, m, dev, odom=motion)
                      for _ in range(COMPILED_CHAIN)]
            n_keys = len(graphs[path].entries)
            first = first_call(graphs[path], lambda: jit_fn(state, noises[0]))
            diff, arms, eager, compiled, _ = compiled_chain(label, state, noises, eager_fn,
                                                            jit_fn, graphs[path])
            again, s = [], state
            for nz in noises:
                s = eager_fn(s, nz)
                again.append(s)
            twice = compare_chain(label + " (eager twice)", eager, again)
            log(f"{label}: eager vs eager {twice}, eager vs compiled {diff}")
            check_state(compiled[-1], params, label)
            keys, captures = len(graphs[path].entries), graphs[path].captures
            check(captures == keys, f"{label}: {captures} captures of {keys} keys")
            # one key per (map, model, backend): the cells of a key replay its graph
            new_keys = keys - n_keys
            check(new_keys == (0 if (path, c.model, c.backend) in keyed else 1),
                  f"{label}: {new_keys} new keys")
            keyed.add((path, c.model, c.backend))
            entry_s = [e.capture_s for e in graphs[path].entries.values()]
            # timings: the pinned step of bench.py, compiled and eager
            out = step_figures(label, state, m, {"compiled": jit_fn, "eager": eager_fn},
                               lambda: mcl.StepNoise.draw(gen, m, dev, odom=motion), smi)
            log(f"{label}: {COMPILED_CHAIN} chained steps equal to the eager step (poses, "
                f"weights, n_active, converged, integer statistics bit for bit; float "
                f"statistics max diff {diff}); arms {dict(arms)}; keys {keys} (new: "
                f"{new_keys}), captures {captures} (one a key), capture s "
                f"{[round(x, 4) for x in entry_s]}, first call {first['first_call_s']:.3f} s; "
                f"top device ops compiled "
                + "; ".join(f"{n} {t:.4f}" for n, t in out["compiled"]["top_device_ops"]))
            rows[f"{key}/{path}"] = dict(out, arms=dict(arms), chain_stats_diff=diff,
                                         captures=captures, capture_s=entry_s)

    # likelihood_only_jit on the tracking cloud: bit-equal to the eager one
    params, state, _ = cell_state("tracking", states)
    like = mcl.likelihood_only(state, maps["likelihood_field"], sp, scan, backend="corr")
    like_c = mcl.likelihood_only_jit(state, maps["likelihood_field"], sp, scan, backend="corr")
    check(torch.equal(like, like_c), "likelihood_only_jit differs from likelihood_only")
    ms = cuda_ms(lambda: mcl.likelihood_only_jit(state, maps["likelihood_field"], sp, scan,
                                                 backend="corr"))
    log(f"compiled tracking/likelihood_only: bit-equal to the eager likelihood, "
        f"likelihood_ms compiled {ms:.4f}")
    rows["tracking/likelihood_only"] = dict(likelihood_ms=ms)

    # the compiled path's launches: each arm's captured launches times its
    # device counter, the rest once a replay
    launches, replays = collections.Counter(), 0
    for graph in (*graphs.values(), mcl.likelihood_only_jit.graph):
        for entry in graph.entries.values():
            launches.update(entry.capture.replay_launches(entry.replays))
            replays += entry.replays
        launches.update(graph.dropped_launches)  # and those of the entries it dropped
    for k in ("corr_table", "spread_term_sums", "lf_term_sums", "lf_extents",
              "cluster_labels"):
        check(launches[k] > 0, f"the compiled path never launched {k} in a replay")
    log(f"compiled path: {replays} replays, kernel launches inside them {dict(launches)}")
    return {k: (n, replays) for k, n in launches.items()}, rows


# --- 2D beam, Gompertz and prob models ----------------------------------------


def phase_range_image(dev, omap):
    """Bake the range image of the flagship map on the card (timed), and a
    256^2 map on the card and the CPU, which must agree bit for bit."""
    import dataclasses

    import torch

    from badger_amcl_tpu_torch import scenario
    from badger_amcl_tpu_torch.maps import range_image as ri

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bmap = omap.with_range_image(RANGE_IMAGE_BINS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check(bmap.range_rows is not None, "range_rows were not baked")
    nbytes = 2 * (bmap.range_image.numel() + bmap.range_rows.numel())
    small = scenario.map_cells(256, 0)
    card = ri.build_range_image(torch.as_tensor(small, device=dev), RANGE_IMAGE_BINS)
    host = ri.build_range_image(torch.as_tensor(small), RANGE_IMAGE_BINS)
    same = bool((card.view(torch.int16).cpu() == host.view(torch.int16)).all())
    check(same, "the 256^2 range image baked on the card differs from the CPU bake")
    log(f"range image: {RANGE_IMAGE_BINS} x {MAP_CELLS}^2 baked on the card in {secs:.4f} s "
        f"(image + transposed rows: {nbytes / 2**20:.0f} MiB); 256^2 card bake bit-equal "
        f"to the CPU bake: {same}")
    return dataclasses.replace(omap, range_image=bmap.range_image,
                               range_rows=bmap.range_rows), secs, nbytes


def phase_kernels_beam(dev, bmap, scan, states):
    """beam_table on the steady (its 24-row window) and tracking (the 64-row
    window) clouds, bit-equal to its plain version, also with a value table
    of every uint16 value (the kernel's device-memory arm);
    beam_spread_sums on the spread cloud against its plain version."""
    import torch

    from badger_amcl_tpu_torch.ops import beam_kernel as bk
    from badger_amcl_tpu_torch.ops import beam_spread_kernel as bsk
    from badger_amcl_tpu_torch.ops import corr_kernel as ck
    from badger_amcl_tpu_torch.sensors import planar

    sp = planar.PlanarScanParams()
    k_angles = bmap.range_image.shape[0]
    mix = bk.BeamMix.of(sp, scan.range_max, bmap.resolution)
    cap = bk.table_cap(mix)
    results = {}
    rows_out = []
    for cell, rows in (("beam_steady", None), ("beam_tracking", 64)):
        spose = planar.coord_add(sp.scanner_pose, states[cell][1].poses)
        pre = bk.beam_prepass(bmap, spose, scan.range_max)
        check(bool(pre["fits"]), f"beam prepass does not fit the {cell} cloud")
        if rows is None:
            rows, j0 = ck.window_variant(pre, bool(pre["tight"]), bool(pre["narrow"]))
        else:
            j0 = pre["j0"]
        args = (bmap.range_image, scan.ranges, scan.angles, pre["t_n"], pre["t_min"],
                pre["t_order"], bk.window_origin(pre, j0), mix, pre["dtheta"], rows)
        got = bk.beam_table(*args)
        want = bk.beam_table_plain(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        check(torch.equal(got, want), f"beam_table[{rows}] differs from its plain version in "
                                      f"{int((got != want).sum())} cells (max err {err})")
        ms = cuda_ms(lambda: bk.beam_table(*args))
        ops = kernel_ms(lambda: bk.beam_table(*args))
        plain_ms = cuda_ms(lambda: bk.beam_table_plain(*args), iters=5, warmup=1)
        t_n = int(pre["t_n"])
        # the slabs it reads once, the t_n live bins of the table written
        # once; 2 operations per (bin, beam, cell) (min, add) and 16 per
        # (beam, v) of the value table; beside it the per-element mixture's
        # count, 16 operations per (bin, beam, cell) with exp as one
        slabs = int(bk.slab_indices(pre["t_min"], pre["t_order"][:t_n], scan.angles,
                                    pre["dtheta"], k_angles).unique().numel())
        nbytes = slabs * rows * ck.PWIN_C * 2 + t_n * rows * ck.PWIN_C * 4 + N_BEAMS * 8
        cells = t_n * N_BEAMS * rows * ck.PWIN_C
        b = bound(nbytes, 2.0 * cells + 16.0 * N_BEAMS * (cap + 1))
        b_old = bound(nbytes, 16.0 * cells)
        log(f"beam_table rows={rows} ({cell}, {states[cell][1].poses.shape[0]} "
            f"particles): t_n={t_n} slabs={slabs} cap={cap} bit_equal=True (table max "
            f"{scale:.4g}) ms={ms:.4f} (wrapper) device_ms={device_text(ops)} "
            f"({'; '.join(f'{n} {t:.4f}' for n, t in ops.items())}) plain_ms={plain_ms:.4f} "
            f"bound_ms={b['bound_ms']:.5f} ({b['bound_by']}; the per-element mixture's "
            f"{b_old['bound_ms']:.5f}, {b_old['bound_by']})")
        rows_out.append((err, ms, plain_ms, b))
    results["beam_table"] = dict(max_abs_err=max(r[0] for r in rows_out), ms=rows_out[0][1],
                                 plain_ms=rows_out[0][2], **rows_out[0][3], library_ms=None)

    # no cap limit: at 1e-4 m per range unit no uint16 value reaches 8 m,
    # so the value table takes all 65,536 values (189 MB at 720 beams)
    mix_w = bk.BeamMix.of(sp, scan.range_max, 1e-4)
    check(bk.table_cap(mix_w) == 65535, "the wide value table's cap is not 65535")
    args_w = (*args[:7], mix_w, *args[8:])
    got = bk.beam_table(*args_w)
    want = bk.beam_table_plain(*args_w)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "beam_table with a 65,536-entry value table differs from "
                                  "its plain version")
    log(f"beam_table rows={rows} (beam_tracking, cap 65535): bit_equal=True")
    del got, want

    spose = planar.coord_add(sp.scanner_pose, states["beam_spread"][1].poses)
    check(bsk.fits(bmap, scan.range_max), "beam spread value table does not fit")
    pre = bsk.beam_spread_prepass(bmap, spose, scan.angles)
    phi = bsk.phi_tables(bmap, sp, scan, pre["kap"])
    args = (bmap.range_rows, pre["flat"], pre["sig"], pre["gocc"], pre["n_g"], phi,
            bsk.value_cap(bmap, scan.range_max))
    got = bsk.beam_spread_sums(*args)
    want = bsk.beam_spread_sums_plain(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    rel = float(((got - want).abs() / want.abs().clamp(min=1e-30)).max())
    check(rel <= 1e-5, f"beam_spread_sums rel err {rel} > 1e-5")
    bit_equal = bool(torch.equal(got, want))
    # the kernel's row path for K not a multiple of 8 (no 16-byte loads):
    # 252 of the 256 slabs, every other offset occupied
    k_odd = 252
    gocc_odd = torch.zeros((k_odd,), dtype=torch.int32, device=dev)
    gocc_odd[:k_odd // 2] = torch.arange(0, k_odd, 2, dtype=torch.int32, device=dev)
    rows_odd = bmap.range_rows.view(torch.int16)[:, :k_odd].contiguous().view(torch.uint16)
    args_odd = (rows_odd, pre["flat"], pre["sig"] % k_odd,
                gocc_odd, torch.tensor(k_odd // 2, dtype=torch.int32, device=dev),
                phi[:k_odd].contiguous(), args[-1])
    got_odd = bsk.beam_spread_sums(*args_odd)
    want_odd = bsk.beam_spread_sums_plain(*args_odd)
    torch.cuda.synchronize()
    rel_odd = float(((got_odd - want_odd).abs() / want_odd.abs().clamp(min=1e-30)).max())
    check(rel_odd <= 1e-5, f"beam_spread_sums at K = {k_odd}: rel err {rel_odd} > 1e-5")
    del got_odd, want_odd, args_odd, rows_odd
    ms = cuda_ms(lambda: bsk.beam_spread_sums(*args))
    ops = kernel_ms(lambda: bsk.beam_spread_sums(*args))
    plain_ms = cuda_ms(lambda: bsk.beam_spread_sums_plain(*args), iters=5, warmup=1)
    m, n_g = spose.shape[0], int(pre["n_g"])
    cells = int(pre["flat"].unique().numel())
    # the K-vectors of the cells the particles occupy, flat/sig/out and Phi;
    # 3 operations per (particle, offset): index, min, add
    b = bound(cells * k_angles * 2 + m * 16 + phi.numel() * 4, 3.0 * m * n_g)
    log(f"beam_spread_sums (beam_spread, {m} particles): n_g={n_g} cells={cells} "
        f"max_abs_err={err:.3e} max_rel_err={rel:.3e} "
        f"bit_equal={float((got == want).float().mean()):.6f} (all: {bit_equal}; "
        f"K = {k_odd}: max_rel_err={rel_odd:.3e}) ms={ms:.4f} (wrapper) "
        f"device_ms={device_text(ops)} plain_ms={plain_ms:.4f} "
        f"bound_ms={b['bound_ms']:.5f} ({b['bound_by']})")
    results["beam_spread_sums"] = dict(max_abs_err=err, ms=ms, device_ms=device_ms(ops),
                                       plain_ms=plain_ms, **b, library_ms=None)
    return results


# --- 2D int8 corr backend ------------------------------------------------------


def phase_kernels_q(omap, scan, states):
    """corr_table_q on the tracking cloud in its narrow 32-row window (the
    window "corr_q" takes) and the standard 64-row one, against its plain
    version: int32, bit-equal; also with the window at the texture's corner
    (the kernel's clamped loop) and with every bin live."""
    import torch

    from badger_amcl_tpu_torch.ops import corr_kernel as ck
    from badger_amcl_tpu_torch.sensors import planar

    sp = planar.PlanarScanParams()
    spose = planar.coord_add(sp.scanner_pose, states["tracking"][1].poses)
    pre = ck.corr_prepass(omap, spose, scan.ranges, scan.angles, scan.valid(), dedup=True)
    check(bool(pre["fits"]) and bool(pre["narrow"]), "the tracking cloud is not narrow")
    tex_q, qscale = omap.corr_psi_pad_q, omap.corr_psi_q
    qstep, qoff = float(qscale[0]), float(qscale[1])
    # the conv2d yardstick reads the dequantized texture (one f32 copy)
    deq = tex_q.to(torch.float32) * qscale[0] + qscale[1]
    out = []
    for rows, j0 in ((32, pre["j0_narrow"]), (64, pre["j0"])):
        args = (tex_q, pre["off"], pre["nu"], pre["t_n"], ck.table_origin(pre, j0, ck.PAD_RQ),
                N_BEAMS, rows)
        got = ck.corr_table_q(*args)
        want = ck.corr_table_q_plain(*args)
        torch.cuda.synchronize()
        check(got.dtype == torch.int32 and torch.equal(got, want),
              f"corr_table_q[{rows}] differs from plain in "
              f"{int((got != want).sum())} cells")
        ms = cuda_ms(lambda: ck.corr_table_q(*args))
        ops = kernel_ms(lambda: ck.corr_table_q(*args))
        us = host_us(lambda: ck.corr_table_q(*args))
        plain_ms = cuda_ms(lambda: ck.corr_table_q_plain(*args))
        conv, win_bytes, taps = corr_conv2d(ck, deq, *args[1:])
        t_n = int(pre["t_n"])
        deq_got = got[:t_n].to(torch.float32) * qstep + int(pre["nv"]) * qoff
        lib_err = float(((conv()[0] - deq_got).abs() / deq_got.abs().max()).max())
        lib_ms = cuda_ms(conv)
        # the t_n live bins, int8 texels (a quarter of the f32 window) and 2
        # integer ops per (tap, cell): multiply by the tap's weight, add
        b = bound(t_n * rows * ck.PWIN_C * 4 + taps * 4 + win_bytes // 4,
                  2.0 * taps * rows * ck.PWIN_C)
        floor = gather_floor_ms(taps * rows * ck.PWIN_C, 1)
        log(f"corr_table_q rows={rows} (tracking): t_n={t_n} taps={taps} bit_equal=True "
            f"ms={ms:.4f} (wrapper) device_ms={device_text(ops)} host_us={us:.2f} "
            f"plain_ms={plain_ms:.4f} bound_ms={b['bound_ms']:.5f} ({b['bound_by']}) "
            f"gather_floor_ms={floor:.5f} (load instructions) conv2d_ms={lib_ms:.4f} "
            f"(conv2d over the dequantized texture, max rel err {lib_err:.3e})")
        out.append(dict(max_abs_err=0.0, ms=ms, device_ms=device_ms(ops), host_us=us,
                        plain_ms=plain_ms, **b, library_ms=lib_ms))
    # the clamped arm (the window at the texture's corners) and every bin live
    for label, cargs in (*clamped_windows(ck, *args),
                         (f"all {ck.T_MAX} bins live", all_bins_live(ck, *args))):
        got = ck.corr_table_q(*cargs)
        want = ck.corr_table_q_plain(*cargs)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"corr_table_q ({label}) differs from plain in "
                                      f"{int((got != want).sum())} cells")
        log(f"corr_table_q rows={args[-1]} (tracking, {label}): bit_equal=True")
    return {"corr_table_q": out[0]}


# --- 2D cell-space resampling contract -----------------------------------------

# the cells of the cell contract: key of CELLS_2D (its state and cloud) ->
# laser model; prob in the exp form, as the contract combines it
CELL_CONTRACT = {"steady": "likelihood_field", "tracking": "likelihood_field",
                 "gompertz_steady": "likelihood_field_gompertz",
                 "prob_steady": "likelihood_field_prob", "spread": "likelihood_field"}
CELLS_REF = (4096, 360)  # card vs CPU: particles, beams (448^2 map)


def contract_step(omap, sp, scan, pool, params, model, contract, gen=None, noise=None):
    """s -> `sensor_resample_step` on "corr" under the given resampling
    contract, variates from `noise` or `gen`."""
    from badger_amcl_tpu_torch import mcl

    return lambda s: mcl.sensor_resample_step(s, omap, sp, scan, pool, params,
                                              laser_model=model, backend="corr",
                                              resample_contract=contract, noise=noise,
                                              generator=gen)


def scan_repeats(dev, calls=200):
    """How many of `calls` repeated scans of one seeded (N_PARTICLES,)
    weight vector differ in any bit from the first: PyTorch's one-row CUDA
    cumsum, and `numerics.cumsum_det`, which the resampling picks take and
    which must never differ."""
    import torch

    from badger_amcl_tpu_torch.utils.numerics import cumsum_det

    g = torch.Generator(device=dev).manual_seed(13)
    w = torch.rand(N_PARTICLES, generator=g, device=dev)
    w = w / w.sum()
    first = torch.cumsum(w, 0), cumsum_det(w)
    torch_diff = sum(not torch.equal(torch.cumsum(w, 0), first[0]) for _ in range(calls))
    det_diff = sum(not torch.equal(cumsum_det(w), first[1]) for _ in range(calls))
    log(f"scan repeats ({N_PARTICLES} weights, {calls} calls): torch.cumsum differed "
        f"{torch_diff} times, cumsum_det {det_diff} times; max |cumsum_det - "
        f"torch.cumsum| {float((first[1] - first[0]).abs().max()):.3e}")
    check(det_diff == 0, f"cumsum_det differed on {det_diff} of {calls} calls")
    return dict(calls=calls, torch_cumsum_differed=torch_diff, cumsum_det_differed=det_diff)


def cell_picks_chi_square(omap, sp, scan, state, params, pool, gen):
    """One cell step of the flagship cloud with each particle's index as
    its pose (the contract reads poses only as the payload of its picks):
    the per-cell pick counts against the cell masses cnt_c p_c / T, cells
    whose expected count is under 5 pooled. Returns (p, cells, bins)."""
    import numpy as np
    import torch
    from scipy import stats as scipy_stats

    from badger_amcl_tpu_torch import mcl
    from badger_amcl_tpu_torch.pf import filter as pf_filter
    from badger_amcl_tpu_torch.sensors import planar

    m = params.max_samples
    tbl, key_m, ok = planar.planar_likelihood_cells(omap, sp, scan, state.poses,
                                                    "likelihood_field")
    check(ok, "cells chi-square: the steady cloud left the cell envelope")
    ident = torch.zeros_like(state.poses)
    ident[:, 0] = torch.arange(m, dtype=torch.float32, device=ident.device)
    noise = mcl.StepNoise.draw(gen, m, ident.device, odom=False)

    def no_classic():
        raise Failure("cells chi-square: the classic arm was taken")

    out = pf_filter.sensor_resample_cells(state.replace(poses=ident), params, pool, tbl, key_m,
                                          ok, no_classic, noise.inject, noise.pick)
    check(bool((out.poses[:, 1:] == 0).all()), "cells chi-square: draws came from the pool")
    _, cell = torch.unique(key_m, return_inverse=True)
    mass = torch.bincount(cell, weights=tbl[key_m].double()).cpu().numpy()
    seen = torch.bincount(cell[out.poses[:, 0].long()], minlength=mass.size).cpu().numpy()
    expected = m * mass / mass.sum()
    small = expected < 5.0
    obs = np.append(seen[~small], seen[small].sum())
    exp = np.append(expected[~small], expected[small].sum())
    keep = exp > 0
    _, p = scipy_stats.chisquare(obs[keep], exp[keep] * obs[keep].sum() / exp[keep].sum())
    return float(p), int(mass.size), int(keep.sum())


def phase_cells(dev, maps, scan, states):
    """The cell-space resampling contract at 50,000 x 720
    (`sensor_resample_step(resample_contract="cell")` on "corr"): per cell
    the arm taken (steady: the cell arm; spread: the pick contract's step,
    equal to it on the same variates), u_count, corr_table launches of 3
    steps and 3 pinned steps, the timing rows of the cell and the pick
    contract on the same state, and a chi-square of one steady cell step's
    per-cell picks. Returns (launch counts, timings)."""
    import torch

    from badger_amcl_tpu_torch import mcl
    from badger_amcl_tpu_torch.ops import cluster_kernel as clk
    from badger_amcl_tpu_torch.ops import corr_kernel as ck
    from badger_amcl_tpu_torch.ops import spread_kernel as sk
    from badger_amcl_tpu_torch.pf import filter as pf_filter
    from badger_amcl_tpu_torch.pf import kld
    from badger_amcl_tpu_torch.sensors import planar

    sp = planar.PlanarScanParams()
    counts = Launches({"cluster_labels": clk.cluster_labels, "corr_table": ck.corr_table,
                       "spread_term_sums": sk.spread_term_sums})
    gen = torch.Generator(device=dev).manual_seed(11)
    timings = {"scan_repeats": scan_repeats(dev)}
    for key, model in CELL_CONTRACT.items():
        omap = maps[model]
        params, state, pool = states[key]
        step_fn = contract_step(omap, sp, scan, pool, params, model, "cell", gen)
        step, box = pinned_step_fn(step_fn, state, params.max_samples)
        arms0 = dict(pf_filter.CELL_ARMS)

        def run():
            s = state
            for _ in range(3):
                s = step_fn(s)
            check_state(s, params, f"cells {key}")
            for _ in range(3):
                step()
            torch.cuda.synchronize()

        rose = counts.run(run, 6)
        check_state(box["out"], params, f"cells {key} pinned")
        arms = {a: pf_filter.CELL_ARMS[a] - arms0.get(a, 0) for a in ("cell", "classic")}
        tbl, key_m, ok = planar.planar_likelihood_cells(omap, sp, scan, state.poses, model)
        u_count = int(kld.sort_by_bin(key_m, state.active_mask)[3].sum()) if ok else None
        if key == "steady":
            check(arms == {"cell": 6, "classic": 0}, f"cells steady: arms {arms}")
        if key == "spread":
            check(arms == {"cell": 0, "classic": 6} and rose["spread_term_sums"] > 0,
                  f"cells spread: arms {arms}, spread_term_sums launched "
                  f"{rose['spread_term_sums']} times")
            noise = mcl.StepNoise.draw(gen, params.max_samples, dev, odom=False)
            a, b = (contract_step(omap, sp, scan, pool, params, model, c, noise=noise)(state)
                    for c in ("cell", "pick"))
            check(torch.equal(a.poses, b.poses) and torch.equal(a.n_active, b.n_active)
                  and torch.equal(a.weights, b.weights),
                  "cells spread: the classic arm differs from the pick step")
        else:
            check(rose["corr_table"] >= arms["cell"] > 0 or arms["classic"] == 6,
                  f"cells {key}: corr_table launched {rose['corr_table']} times, arms {arms}")
        out = box["out"]
        log(f"cells {key} ({model}, cell contract): arms {arms} of 6 steps, u_count "
            f"{u_count}, launches { {k: v for k, v in rose.items() if v} }, n_active "
            f"{int(out.n_active)}, w_slow {float(out.w_slow):.4g}, "
            f"mean={[round(v, 4) for v in out.stats.mean.tolist()]}")
        pick_step, _ = pinned_step_fn(
            contract_step(omap, sp, scan, pool, params, model, "pick", gen), state,
            params.max_samples)

        def like_pick():
            p, mf = planar.planar_likelihood(omap, sp, scan, state.poses, state.active_mask,
                                             state.n_active, model, backend="corr",
                                             fold_factors=True)
            return p if mf is None else p * mf

        timings[key] = dict(
            arms=arms, u_count=u_count, corr_table_launches=rose["corr_table"],
            cell=timing_row(f"cells {key} cell", lambda: planar.planar_likelihood_cells(
                omap, sp, scan, state.poses, model), step),
            pick=timing_row(f"cells {key} pick", like_pick, pick_step))
    params, state, pool = states["steady"]
    p, n_cells, bins = cell_picks_chi_square(maps["likelihood_field"], sp, scan, state, params,
                                             pool, gen)
    log(f"cells chi-square (steady, {params.max_samples} picks over {n_cells} cells, {bins} "
        f"bins): p = {p:.4g}")
    check(p > 1e-3, f"cells chi-square: p = {p:.3g}")
    timings["chi_square"] = dict(p=p, cells=n_cells, bins=bins)
    return counts.read(), timings


def compiled_chain(label, state, noises, eager_fn, jit_fn, graph, counts=None):
    """The compiled entry against its eager function over chained steps on
    the same variates: (compare_chain's float diffs, the compiled arms
    (device counters), the eager and the compiled states, the launch
    counts of the replays where `counts` (Launches) is given). Checks the
    arms equal and no host sync inside a replay (SYNCS, sync debug mode
    "error")."""
    import torch

    from badger_amcl_tpu_torch.utils import control
    from badger_amcl_tpu_torch.utils.numerics import SYNCS

    control.ARMS.clear()
    eager, s = [], state
    for nz in noises:
        s = eager_fn(s, nz)
        eager.append(s)
    eager_arms = +collections.Counter(control.ARMS)
    arms0, s0 = graph_arms(graph), SYNCS.count
    compiled = []

    def run():
        s = state
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for nz in noises:
                s = jit_fn(s, nz)
                compiled.append(s)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()

    rose = counts.run(run, len(noises)) if counts is not None else run()
    syncs = SYNCS.count - s0
    check(syncs == 0, f"{label}: {syncs} host syncs inside the replays")
    arms = +(graph_arms(graph) - arms0)
    check(arms == eager_arms, f"{label}: compiled arms {dict(arms)} != eager {dict(eager_arms)}")
    return compare_chain(label, eager, compiled), arms, eager, compiled, rose


def step_figures(label, state, m, fns, draw, smi, iters=ITERS, warmup=WARMUP, busy_steps=5):
    """{mode: step_ms, device busy, ops, idle share, host syncs a step} of
    each (state, noise) -> state function in fns ({mode: fn}) as a pinned
    step on fresh draws; the compiled mode must take no host sync. With
    busy_steps 0 the profiler does not run (its processing of a step that
    runs 256 robots one by one takes tens of seconds): busy "not
    measured"."""
    from badger_amcl_tpu_torch.utils.numerics import SYNCS

    out = {}
    for mode, fn in fns.items():
        step, _ = pinned_step_fn(lambda st, f=fn: f(st, draw()), state, m)
        step_ms = cuda_ms(step, iters=iters, warmup=warmup)
        busy_ms, ops, top = device_busy(step, steps=busy_steps) if busy_steps else (None, 0, [])
        s0 = SYNCS.count
        step()
        out[mode] = dict(step_ms=step_ms, device_busy_ms=busy_ms, device_ops_per_step=ops,
                         device_idle_share=1.0 - busy_ms / step_ms if ops else None,
                         host_syncs_per_step=SYNCS.count - s0, top_device_ops=top)
    check(out["compiled"]["host_syncs_per_step"] == 0,
          f"{label}: the pinned compiled step took host syncs")

    def busy(row):
        return (f"{row['device_busy_ms']:.4f} (idle share {row['device_idle_share']:.3f})"
                if row["device_ops_per_step"] else "not measured")

    co, ea = out["compiled"], out["eager"]
    log(f"{label}: step_ms compiled {co['step_ms']:.4f} eager {ea['step_ms']:.4f}; device busy "
        f"ms compiled {busy(co)} eager {busy(ea)}; host syncs per step compiled 0 eager "
        f"{ea['host_syncs_per_step']} ({smi})")
    return out


def first_call(graph, fn):
    """fn() (the compiled entry's first call of a key), timed: {first call
    s, and for a new key its capture s, graph nodes, arm bodies and
    memory_reserved before and after}."""
    import torch

    captures0, entries0 = graph.captures, {id(e) for e in graph.entries.values()}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # so that a new entry's blocks show in memory_reserved
    reserved0 = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    out = dict(first_call_s=time.perf_counter() - t0)
    new = [e for e in graph.entries.values() if id(e) not in entries0]
    if graph.captures > captures0 and new:
        e = new[0]
        out.update(capture_s=e.capture_s, graph_nodes=e.nodes, arm_bodies=len(e.capture.slots),
                   reserved_gb_before=reserved0 / 1e9,
                   reserved_gb_after=torch.cuda.memory_reserved() / 1e9)
    return out


def phase_cells_compiled(dev, maps, scan, states, smi):
    """The compiled cell contract (`sensor_resample_step_jit(
    resample_contract="cell")`, one cond "cells.ok" between the cell arm
    and the pick step) in the CELL_CONTRACT cells at 50,000 x 720:
    COMPILED_CHAIN chained replays against the eager cell step on the same
    variates (compare_chain), the device arms equal to the eager arms (the
    cell arm on every step of the four tight cells, the pick step on every
    step of the spread one), no host sync inside a replay, one capture a
    key; compiled and eager step_ms, host syncs a step, device busy and
    idle share, each new key's capture seconds, graph nodes and
    memory_reserved. Returns (the path's launch counts, timings)."""
    import torch

    from badger_amcl_tpu_torch import mcl
    from badger_amcl_tpu_torch.sensors.planar import PlanarScanParams

    sp = PlanarScanParams()
    graph = mcl.sensor_resample_step_jit.graph
    graph.kernels.update(counters_2d())
    counts = Launches(counters_2d(), [graph])
    captures0, keys0 = graph.captures, len(graph.entries)
    out = {}
    for key, model in CELL_CONTRACT.items():
        tag = f"cells_compiled {key} ({model})"
        omap = maps[model]
        params, state, pool = states[key]
        m = params.max_samples
        kw = dict(laser_model=model, backend="corr", resample_contract="cell")
        gen = torch.Generator(device=dev).manual_seed(11)
        noises = [mcl.StepNoise.draw(gen, m, dev, odom=False) for _ in range(COMPILED_CHAIN)]

        def eager_fn(s, nz, omap=omap, pool=pool, params=params):
            return mcl.sensor_resample_step(s, omap, sp, scan, pool, params, noise=nz, **kw)

        def jit_fn(s, nz, omap=omap, pool=pool, params=params):
            return mcl.sensor_resample_step_jit(s, omap, sp, scan, pool, params, noise=nz, **kw)

        first = first_call(graph, lambda: jit_fn(state, noises[0]))
        diff, arms, _, compiled, rose = compiled_chain(tag, state, noises, eager_fn, jit_fn,
                                                       graph, counts)
        want = "cells.ok:false" if key == "spread" else "cells.ok:true"
        check(arms[want] == COMPILED_CHAIN, f"{tag}: {want} taken {arms[want]} times in "
                                            f"{COMPILED_CHAIN} replays (arms {dict(arms)})")
        check_state(compiled[-1], params, tag)
        figs = step_figures(tag, state, m, {"compiled": jit_fn, "eager": eager_fn},
                            lambda: mcl.StepNoise.draw(gen, m, dev, odom=False), smi)
        out[key] = dict(figs, arms=dict(arms), chain_stats_diff=diff, **first,
                        launches=dict(rose))
        log(f"{tag}: {COMPILED_CHAIN} chained replays equal to the eager cell step (float "
            f"statistics max diff {diff}); arms {dict(arms)}; launches inside the replays "
            f"{ {k: v for k, v in rose.items() if v} }; first call {first}")
    keys = len(graph.entries) - keys0
    check(graph.captures - captures0 == keys, f"cells_compiled: {graph.captures - captures0} "
                                              f"captures for {keys} new keys")
    check(counts.replayed["corr_table"] > 0, "cells_compiled: #1 never launched in a replay")
    out["new_keys"] = keys
    return counts.read(), out


def phase_cells_reference(dev):
    """The cell contract's step on the card (kernel) against the same step
    on the CPU (plain version), same inputs and draws, at 4096 x 360 on a
    448^2 map: steady and tracking likelihood field, steady Gompertz;
    >= 99.9% of picks equal (the tables' sums differ in order, and the
    cumulative masses with them), n_active equal, the cell arm on both."""
    import torch

    from badger_amcl_tpu_torch import mcl, scenario
    from badger_amcl_tpu_torch.pf import filter as pf_filter
    from badger_amcl_tpu_torch.sensors import planar

    sp = planar.PlanarScanParams()
    n, b = CELLS_REF
    omap_g = scenario.build_map(448, device=dev)
    omap_c = to_device(omap_g, "cpu")
    scan_c = scenario.build_scan(b, device="cpu")
    for regime, model in (("steady", "likelihood_field"), ("tracking", "likelihood_field"),
                          ("steady", "likelihood_field_gompertz")):
        params, state_c, pool_c = scenario.build_filter(n, pose_cov=REGIMES[regime],
                                                        min_particles=1024, device="cpu")
        noise_c = mcl.StepNoise.draw(torch.Generator().manual_seed(7), n, "cpu", odom=False)
        arms0 = pf_filter.CELL_ARMS["cell"]
        out_c, out_g = (
            contract_step(om, sp, to_device(scan_c, d), to_device(pool_c, d), params, model,
                          "cell", noise=to_device(noise_c, d))(to_device(state_c, d))
            for om, d in ((omap_c, "cpu"), (omap_g, dev)))
        check(pf_filter.CELL_ARMS["cell"] == arms0 + 2,
              f"cells reference {model}/{regime}: the cell arm was not taken on both")
        same = (out_g.poses.cpu() == out_c.poses).all(dim=1).float().mean().item()
        check(int(out_g.n_active) == int(out_c.n_active),
              f"cells reference {model}/{regime}: n_active differs")
        check(same >= 0.999, f"cells reference {model}/{regime}: picks equal {same:.4f}")
        log(f"cells reference {model}/{regime} ({n} x {b} on 448^2, card vs CPU, cell "
            f"contract): picks equal {same:.4f}, n_active {int(out_g.n_active)}")


# --- fleet -------------------------------------------------------------------


def fleet_conv2d(ck, tex_pad, off, nv, t_n, org, n_beams, rows):
    """All R fleet tables as ONE grouped torch.nn.functional.conv2d: robot
    r's bins are output channels of group r, their unit taps scattered into
    one (kh, kw) weight spanning every robot's offsets, over the robot's
    own texture window. Returns (call, window bytes, live taps, bins per
    robot in the output)."""
    import torch
    import torch.nn.functional as F

    r, t_max = org.shape[0], ck.T_MAX
    dev = tex_pad.device
    w, oj, oi = ck._unpack(off.reshape(r, t_max, n_beams))
    live = ((torch.arange(n_beams, device=dev) < nv[:, None, None])
            & (torch.arange(t_max, device=dev)[:, None] < t_n[:, None, None]))
    j_lo, j_hi = int(oj[live].min()), int(oj[live].max())
    i_lo, i_hi = int(oi[live].min()), int(oi[live].max())
    kh, kw = j_hi - j_lo + 1, i_hi - i_lo + 1
    tm = int(t_n.max())
    rr, tt, bb = live.nonzero(as_tuple=True)
    weight = torch.zeros((r * tm, 1, kh, kw), dtype=torch.float32, device=dev)
    weight.index_put_((rr * tm + tt, torch.zeros_like(rr), oj[rr, tt, bb] - j_lo,
                       oi[rr, tt, bb] - i_lo), w[rr, tt, bb].to(torch.float32), accumulate=True)
    org = org.to(torch.int64)
    rows_i = org[:, 0, None] + j_lo + torch.arange(rows + kh - 1, device=dev)
    cols_i = org[:, 1, None] + i_lo + torch.arange(ck.PWIN_C + kw - 1, device=dev)
    check(int(rows_i.min()) >= 0 and int(rows_i.max()) < tex_pad.shape[0]
          and int(cols_i.min()) >= 0 and int(cols_i.max()) < tex_pad.shape[1],
          "fleet conv2d window leaves the padded texture")
    inp = tex_pad[rows_i[:, :, None], cols_i[:, None, :]][None].contiguous()
    return (lambda: F.conv2d(inp, weight, groups=r)), inp.numel() * 4, int(live.sum()), tm


def phase_kernels_fleet(dev, omap, fl):
    """fleet_corr_table against its plain version on 16 robots scattered
    over the map (their own origins, yaw spreads and bin counts; robot 15
    without a valid beam, whose table must be zero), then at the fleet's
    own shape, timed beside its plain version and one grouped conv2d."""
    import torch

    from badger_amcl_tpu_torch.fleet import FleetScan, fleet_init, fleet_window
    from badger_amcl_tpu_torch.ops import corr_kernel as ck
    from badger_amcl_tpu_torch.pf.types import PFParams
    from badger_amcl_tpu_torch.sensors.planar import PlanarScanParams

    g = torch.Generator(device=dev).manual_seed(11)
    r = 16
    # yaw means inside +-2.5 rad: a cloud across +-pi wraps in coord_add and
    # spans the whole circle of yaw bins, outside the lattice envelope
    span = torch.tensor([40.0, 40.0, 5.0], device=dev)
    means = torch.rand((r, 3), generator=g, device=dev) * span - span / 2
    covs = torch.stack([torch.diag(torch.tensor([0.02, 0.02, 0.0005 * (i + 1)]))
                        for i in range(r)])
    states = fleet_init(PFParams(min_samples=20, max_samples=2000, hist_x=32, hist_y=32,
                                 stats_max_clusters=128), means, covs, generator=g, device=dev)
    scans = FleetScan.tile(fl[2].robot(0), r)
    scans.ranges[15] = scans.range_max[15]
    pre, _, fits, tight, narrow = fleet_window(omap, PlanarScanParams(), scans, states)
    rows, j0 = ck.window_variant(pre, tight, narrow)
    check(fits, "scattered robots leave the lattice envelope: fits "
                f"{pre['fits'].tolist()}, t_n {pre['t_n'].tolist()}")
    org = ck.table_origin(pre, j0)
    args = (omap.corr_psi_pad, pre["off"], pre["nv"], pre["t_n"], org, FLEET_BEAMS, rows)
    got = ck.fleet_corr_table(*args)
    want = ck.fleet_corr_table_plain(*args)
    in_order = ck._table_in_order(*args[:2], pre["nv"][:, None].expand(-1, ck.T_MAX).contiguous(),
                                  *args[3:])
    torch.cuda.synchronize()
    err16 = float((got - want).abs().max())
    scale = float(want.abs().max())
    check(err16 <= 1e-5 * scale, f"fleet_corr_table (16 scattered) err {err16} > 1e-5 x {scale}")
    live = torch.arange(ck.T_MAX, device=dev)[None, :] < pre["t_n"][:, None]
    check(torch.equal(got[live], in_order[live]),
          f"fleet_corr_table (16 scattered) differs from _table_in_order in "
          f"{int((got[live] != in_order[live]).sum())} live cells")
    check(not bool(got[~live].any()), "fleet_corr_table has a nonzero bin past t_n")
    check(int(pre["nv"][15]) == 0 and not bool(got[15].any()),
          "the robot without a valid beam has a nonzero table")
    # robot 3 moved to the texture's corner: its taps leave the texture, and
    # the kernel's clamped loop must still give the plain version's cells
    org_c = org.clone()
    org_c[3] = 0
    args_c = (*args[:4], org_c, *args[5:])
    got_c = ck.fleet_corr_table(*args_c)
    in_order_c = ck._table_in_order(*args_c[:2], pre["nv"][:, None].expand(-1, ck.T_MAX),
                                    *args_c[3:])
    torch.cuda.synchronize()
    check(torch.equal(got_c[live], in_order_c[live]),
          "fleet_corr_table with a window at the texture's corner differs from _table_in_order")
    log(f"fleet_corr_table (16 robots scattered, rows={rows}): t_n "
        f"{pre['t_n'].tolist()}, origins {len(set(map(tuple, org.tolist())))} distinct, "
        f"max_abs_err={err16:.3e} (table max {scale:.4g}), live bins bit-equal to "
        f"_table_in_order (also with robot 3's window at the texture's corner), robot 15 "
        f"(nv=0) zero")

    params, states, scans = fl[0], fl[1], fl[2]
    pre, _, fits, tight, narrow = fleet_window(omap, PlanarScanParams(), scans, states)
    rows, j0 = ck.window_variant(pre, tight, narrow)
    check(fits, "a fleet robot leaves the lattice envelope")
    args = (omap.corr_psi_pad, pre["off"], pre["nv"], pre["t_n"], ck.table_origin(pre, j0),
            FLEET_BEAMS, rows)
    got = ck.fleet_corr_table(*args)
    want = ck.fleet_corr_table_plain(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    check(err <= 1e-5 * scale, f"fleet_corr_table (fleet) err {err} > 1e-5 x {scale}")
    del want
    ms = cuda_ms(lambda: ck.fleet_corr_table(*args))
    device_ms = device_text(kernel_ms(lambda: ck.fleet_corr_table(*args), calls=5))
    plain_ms = cuda_ms(lambda: ck.fleet_corr_table_plain(*args), iters=3, warmup=1)
    conv, win_bytes, taps, tm = fleet_conv2d(ck, *args)
    lib_err = float((conv()[0].reshape(got.shape[0], tm, rows, ck.PWIN_C)
                     - got[:, :tm]).abs().max())
    lib_ms = cuda_ms(conv, iters=3, warmup=1)
    del conv
    # each robot's t_n live bins written once (the zero bins past t_n are
    # read by nothing), the taps and the texture (or the robots' windows,
    # whichever is smaller) read once; one add per (tap, cell): the fleet's
    # taps are unweighted
    tex_bytes = omap.corr_psi_pad.numel() * 4
    live_bytes = int(pre["t_n"].sum()) * rows * ck.PWIN_C * 4
    b = bound(live_bytes + taps * 4 + min(win_bytes, tex_bytes),
              1.0 * taps * rows * ck.PWIN_C)
    t_n = pre["t_n"].to(torch.float32)
    # the floor of any gather: one 4-byte texel per (tap, cell) from L1
    gather_bytes = 4.0 * taps * rows * ck.PWIN_C
    log(f"fleet_corr_table ({got.shape[0]} robots x {params.max_samples} x {FLEET_BEAMS}, "
        f"rows={rows}): t_n mean {float(t_n.mean()):.2f} max {int(t_n.max())}, taps={taps} "
        f"max_abs_err={err:.3e} (table max {scale:.4g}) ms={ms:.4f} device_ms={device_ms} "
        f"plain_ms={plain_ms:.4f} bound_ms={b['bound_ms']:.5f} ({b['bound_by']}) gather bytes "
        f"{gather_bytes:.4g} "
        f"({gather_floor_ms(taps * rows * ck.PWIN_C, 4):.4f} ms at 30 TB/s) "
        f"grouped_conv2d_ms={lib_ms:.4f} "
        f"(conv2d max_abs_err {lib_err:.3e})")
    return {"fleet_corr_table": dict(
        max_abs_err=max(err, err16), ms=ms, plain_ms=plain_ms, **b, library_ms=lib_ms)}


def fleet_step_fn(fl, omap, gen, noise=None):
    """s -> fleet_step(s) on "corr" with the fleet's scans, pools and
    odometry, variates from `noise` or `gen`."""
    from badger_amcl_tpu_torch.fleet import fleet_step
    from badger_amcl_tpu_torch.sensors.planar import PlanarScanParams

    params, _, scans, pools, odom_poses, deltas, alphas = fl
    sp = PlanarScanParams()
    return lambda s: fleet_step(s, omap, sp, scans, pools, odom_poses, deltas, deltas, alphas,
                                params, backend="corr", noise=noise, generator=gen)


def check_fleet(s, params, label):
    """check_state for every robot of a fleet state."""
    import torch

    n = s.n_active
    check(bool(((n >= params.min_samples) & (n <= params.max_samples)).all()),
          f"{label}: n_active {n.min().item()}..{n.max().item()}")
    check(bool(torch.isfinite(s.weights).all() & torch.isfinite(s.poses).all()
               & torch.isfinite(s.stats.mean).all()), f"{label}: non-finite state")
    sums = s.weights.sum(1)
    check(bool(((sums - 1.0).abs() < 1e-4).all()), f"{label}: weight sums "
          f"{sums.min().item()}..{sums.max().item()}")
    check(bool((s.stats.cluster_count >= 1).all()), f"{label}: a robot has no cluster")


def phase_main_path_fleet(dev, omap, fl):
    """Drive the fleet from `fleet_init` through 3 `fleet_step`s with motion
    and 3 pinned steps; the fleet table must launch on each of the 6."""
    import torch

    from badger_amcl_tpu_torch.fleet import fleet_window
    from badger_amcl_tpu_torch.ops import cluster_kernel as clk
    from badger_amcl_tpu_torch.ops import corr_kernel as ck
    from badger_amcl_tpu_torch.ops import lf_kernel as lk
    from badger_amcl_tpu_torch.ops import spread_kernel as sk
    from badger_amcl_tpu_torch.sensors.planar import PlanarScanParams

    params, states, scans = fl[0], fl[1], fl[2]
    counts = Launches({"cluster_labels": clk.cluster_labels,
                       "fleet_corr_table": ck.fleet_corr_table, "corr_table": ck.corr_table,
                       "spread_term_sums": sk.spread_term_sums,
                       "lf_term_sums": lk.lf_term_sums})
    gen = torch.Generator(device=dev).manual_seed(5)
    step_fn = fleet_step_fn(fl, omap, gen)
    step, box = pinned_step_fn(step_fn, states, params.max_samples)
    moved = {}

    def run():
        s = states
        for _ in range(3):
            s = step_fn(s)
        check_fleet(s, params, "fleet fleet_step")
        moved["s"] = s
        for _ in range(3):
            step()
        torch.cuda.synchronize()

    rose = counts.run(run, 6)
    out = box["out"]
    check_fleet(out, params, "fleet pinned step")
    check(rose["fleet_corr_table"] == 6,
          f"fleet_corr_table launched {rose['fleet_corr_table']} times in 6 fleet steps")
    pre, _, _, tight, narrow = fleet_window(omap, PlanarScanParams(), scans, moved["s"])
    rows, _ = ck.window_variant(pre, tight, narrow)
    t_n = pre["t_n"].to(torch.float32)
    log(f"main path fleet ({states.poses.shape[0]} x {params.max_samples} x {FLEET_BEAMS}): "
        f"launches { {k: v for k, v in rose.items() if v} }, window rows={rows}, t_n mean "
        f"{float(t_n.mean()):.2f} max {int(t_n.max())} (after the motion steps), n_active "
        f"{int(out.n_active.min())}..{int(out.n_active.max())}, clusters "
        f"{int(out.stats.cluster_count.min())}..{int(out.stats.cluster_count.max())}, "
        f"converged {float(out.converged.float().mean()):.3f}")
    return counts.read()


def phase_reference_fleet(dev, omap):
    """The fleet step on the card (kernel) against the same step on the CPU
    (plain version), same inputs and draws, at 4 x 2048 x 60; picks equal
    where the poses agree to 1e-5."""
    import torch

    from badger_amcl_tpu_torch import scenario
    from badger_amcl_tpu_torch.fleet import FleetNoise, fleet_likelihood
    from badger_amcl_tpu_torch.ops import corr_kernel as ck
    from badger_amcl_tpu_torch.sensors.planar import PlanarScanParams

    sp = PlanarScanParams()
    omap_c = to_device(omap, "cpu")
    fl_c = scenario.build_fleet(4, 2048, 60, seed=3, device="cpu")
    fl_g = tuple(to_device(x, dev) for x in fl_c)
    noise_c = FleetNoise.draw(torch.Generator().manual_seed(8), 4, 2048, "cpu")
    before = ck.fleet_corr_table.launches
    p_c, mf_c = fleet_likelihood(omap_c, sp, fl_c[2], fl_c[1])
    p_g, mf_g = fleet_likelihood(omap, sp, fl_g[2], fl_g[1])
    check(ck.fleet_corr_table.launches == before + 1, "fleet reference: kernel not launched")
    p_c, p_g = p_c * mf_c, (p_g * mf_g).cpu()
    close = ((p_g - p_c).abs() <= 1e-4 * p_c.abs()).float().mean().item()
    check(close >= 0.999, f"fleet reference: only {close:.4f} of likelihoods agree to 1e-4")
    out_c = fleet_step_fn(fl_c, omap_c, None, noise_c)(fl_c[1])
    out_g = fleet_step_fn(fl_g, omap, None, to_device(noise_c, dev))(fl_g[1])
    # a pick is the same particle: the fleet step runs the motion update,
    # whose f32 trig differs between the card and the CPU in the last ulp
    same = ((out_g.poses.cpu() - out_c.poses).abs() <= 1e-5).all(dim=-1).float().mean().item()
    check(torch.equal(out_g.n_active.cpu(), out_c.n_active), "fleet reference: n_active differs")
    check(same >= 0.999, f"fleet reference: picks equal {same:.4f}")
    log(f"reference fleet (4 x 2048 x 60 on {MAP_CELLS}^2, card vs CPU): likelihoods within "
        f"1e-4: {close:.4f}, picks equal (poses within 1e-5): {same:.4f}, poses bit-equal: "
        f"{(out_g.poses.cpu() == out_c.poses).all(dim=-1).float().mean().item():.4f}, "
        f"n_active {out_g.n_active.tolist()}")


def phase_timings_fleet(dev, omap, fl):
    """timing_row for the fleet step and its likelihood, robot-steps/s, and
    the host syncs of one step at 16 robots, which must equal 256's."""
    import torch

    from badger_amcl_tpu_torch import scenario
    from badger_amcl_tpu_torch.fleet import fleet_likelihood
    from badger_amcl_tpu_torch.sensors.planar import PlanarScanParams
    from badger_amcl_tpu_torch.utils.numerics import SYNCS

    sp = PlanarScanParams()
    params, states, scans = fl[0], fl[1], fl[2]
    gen = torch.Generator(device=dev).manual_seed(6)
    step, _ = pinned_step_fn(fleet_step_fn(fl, omap, gen), states, params.max_samples)
    row = timing_row("fleet", lambda: fleet_likelihood(omap, sp, scans, states), step)
    row["robot_steps_per_s"] = states.poses.shape[0] / (row["step_ms"] / 1e3)
    fl16 = scenario.build_fleet(16, FLEET_PARTICLES, FLEET_BEAMS, device=dev)
    step16, _ = pinned_step_fn(fleet_step_fn(fl16, omap, gen), fl16[1], params.max_samples)
    step16()
    s0 = SYNCS.count
    step16()
    row["host_syncs_per_step_16_robots"] = SYNCS.count - s0
    log(f"timing fleet: robot_steps_per_s={row['robot_steps_per_s']:.1f}, host syncs per step "
        f"{row['host_syncs_per_step']} at {states.poses.shape[0]} robots, "
        f"{row['host_syncs_per_step_16_robots']} at 16")
    check(row["host_syncs_per_step_16_robots"] == row["host_syncs_per_step"],
          "the fleet step's host syncs grow with the robot count")
    return row


# the compiled fleet: chained steps against the eager step, and the seed of
# the spread clouds (REGIMES["spread"]) of its other two fleets
FLEET_CHAIN = 10
FLEET_WIDE_SEED = 9
# the arms each fleet of the compiled-fleet phase must take in its replays
FLEET_ARMS = {"tight": ("fleet.fits:true", "cluster.fleet_u:true"),
              "spread_robot": ("fleet.fits:false", "fleet.robot:body"),
              "wide": ("fleet.fits:false", "fleet.robot:body", "cluster.fleet_u:false")}


def fleet_counters():
    """{name in the kernels line: wrapper} of every kernel a fleet step may
    launch (the robot-by-robot arm runs the single-robot dispatch)."""
    from badger_amcl_tpu_torch.ops import cluster_kernel as clk
    from badger_amcl_tpu_torch.ops import corr_kernel as ck
    from badger_amcl_tpu_torch.ops import lf_kernel as lk
    from badger_amcl_tpu_torch.ops import spread_kernel as sk

    return {"fleet_corr_table": ck.fleet_corr_table, "corr_table": ck.corr_table,
            "spread_term_sums": sk.spread_term_sums, "lf_term_sums": lk.lf_term_sums,
            "lf_extents": lk.beam_extents, "cluster_labels": clk.cluster_labels}


def fleet_cases(dev, fl):
    """{label: fleet state} of the compiled-fleet phase: the flagship fleet
    (every robot tight: the batched table, the compacted ranks), the same
    fleet with robot 0's cloud spread (the robots one by one), and every
    robot's cloud spread (one by one, and more occupied (robot, bin) keys
    than cluster.FLEET_U_MAX: the batched grid ranks)."""
    import torch

    from badger_amcl_tpu_torch import scenario

    wide = scenario.build_fleet(FLEET_ROBOTS, FLEET_PARTICLES, FLEET_BEAMS,
                                seed=FLEET_WIDE_SEED, pose_cov=REGIMES["spread"],
                                device=dev)[1]
    tight = fl[1]
    first = (torch.arange(FLEET_ROBOTS, device=dev) == 0)[:, None, None]
    return {"tight": tight,
            "spread_robot": tight.replace(poses=torch.where(first, wide.poses, tight.poses)),
            "wide": wide}


def phase_fleet_compiled(dev, omap, fl, smi):
    """The compiled fleet step (`make_fleet_step`: one CUDA graph for the
    key, every cond a conditional node) at 256 x 10,000 x 180 on the three
    fleets of `fleet_cases`: FLEET_CHAIN chained replays against eager
    `fleet_step` on the same FleetNoise (compiled_chain: poses, weights,
    n_active and the integer statistics bit for bit, the float statistics
    within STATS_TOL; the device arms equal to the eager arms, FLEET_ARMS
    among them; no host sync inside a replay), one capture for the key,
    #5, #3 and the labelling kernel launched inside replays; per fleet
    compiled and eager step_ms (pinned step, CUDA events), host syncs a
    step, device busy and idle share; the capture's seconds, graph nodes
    and memory_reserved. Returns (the path's launch counts, timings)."""
    import torch

    from badger_amcl_tpu_torch import fleet
    from badger_amcl_tpu_torch.pf import cluster
    from badger_amcl_tpu_torch.sensors.planar import PlanarScanParams

    t_phase = time.perf_counter()
    params, _, scans, pools, odom_poses, deltas, alphas = fl
    sp = PlanarScanParams()
    r, m = FLEET_ROBOTS, FLEET_PARTICLES
    jit = fleet.make_fleet_step(params, backend="corr")
    graph = jit.graph
    counts = Launches(fleet_counters(), [graph])
    t0 = time.perf_counter()
    cases = fleet_cases(dev, fl)
    log(f"fleet_compiled: the spread fleets built in {time.perf_counter() - t0:.2f} s")

    def eager_fn(s, noise):
        return fleet.fleet_step(s, omap, sp, scans, pools, odom_poses, deltas, deltas, alphas,
                                params, backend="corr", noise=noise)

    def jit_fn(s, noise):
        return jit(s, omap, sp, scans, pools, odom_poses, deltas, deltas, alphas, noise=noise)

    out, arms_all = {}, collections.Counter()
    captures0, keys0 = graph.captures, len(graph.entries)
    for label, state in cases.items():
        tag = f"fleet_compiled {label} ({r} x {m} x {FLEET_BEAMS})"
        gen = torch.Generator(device=dev).manual_seed(FLEET_WIDE_SEED + 1)
        noises = [fleet.FleetNoise.draw(gen, r, m, dev) for _ in range(FLEET_CHAIN)]
        first = first_call(graph, lambda: jit_fn(state, noises[0]))
        if "capture_s" in first:
            log(f"{tag}: the key captured in {first['capture_s']:.3f} s (first call "
                f"{first['first_call_s']:.3f} s, warm-up included): {first['graph_nodes']} "
                f"graph nodes, {first['arm_bodies']} arm bodies; memory_reserved "
                f"{first['reserved_gb_before']:.3f} GB -> {first['reserved_gb_after']:.3f} GB "
                f"({smi})")
        t1 = time.perf_counter()
        diff, arms, _, compiled, rose = compiled_chain(tag, state, noises, eager_fn, jit_fn,
                                                       graph, counts)
        chain_s = time.perf_counter() - t1
        for a in FLEET_ARMS[label]:
            check(arms[a] > 0, f"{tag}: {a} not taken inside a replay (arms {dict(arms)})")
        arms_all.update(arms)
        check_fleet(compiled[-1], params, tag)
        occupied = [int(cluster_keys(c, params)) for c in (state, *compiled[:3])]
        # the spread fleets' eager steps run the robots one by one (~1.2 s):
        # two timed steps, no profile
        figs = step_figures(tag, state, m, {"compiled": jit_fn, "eager": eager_fn},
                            lambda: fleet.FleetNoise.draw(gen, r, m, dev), smi,
                            **({} if label == "tight" else dict(iters=2, warmup=0,
                                                                 busy_steps=0)))
        for row in figs.values():
            row["robot_steps_per_s"] = r / (row["step_ms"] / 1e3)
        out[label] = dict(figs, arms=dict(arms), chain_stats_diff=diff, chain_s=chain_s,
                          occupied_robot_bins=occupied, launches=dict(rose), **first)
        log(f"{tag}: {FLEET_CHAIN} chained replays equal to eager fleet_step (poses, weights, "
            f"n_active, integer statistics bit for bit; float statistics max diff {diff}); "
            f"arms {dict(arms)}; occupied (robot, bin) keys before and after the first steps "
            f"{occupied} (FLEET_U_MAX {cluster.FLEET_U_MAX}); launches inside the replays "
            f"{ {k: v for k, v in rose.items() if v} }; both chains {chain_s:.2f} s; "
            f"robot-steps/s compiled {figs['compiled']['robot_steps_per_s']:.1f} eager "
            f"{figs['eager']['robot_steps_per_s']:.1f}")
    check(graph.captures - captures0 == len(graph.entries) - keys0 == 1,
          f"fleet_compiled: {graph.captures - captures0} captures for "
          f"{len(graph.entries) - keys0} new keys")
    for k in ("fleet_corr_table", "cluster_labels", "spread_term_sums"):
        check(counts.replayed[k] > 0, f"fleet_compiled: {k} never launched inside a replay")
    out.update(arms=dict(arms_all), replayed_launches=dict(counts.replayed),
               phase_s=time.perf_counter() - t_phase)
    log(f"fleet_compiled: arms over the three fleets {dict(arms_all)}; launches inside "
        f"replays {dict(counts.replayed)}; the phase took {out['phase_s']:.1f} s")
    return counts.read(), out


def cluster_keys(states, params):
    """The occupied (robot, bin) keys of a fleet's active particles: what
    cluster.FLEET_U_MAX bounds."""
    import torch

    from badger_amcl_tpu_torch.pf import kld

    m = states.weights.shape[1]
    act = torch.arange(m, device=states.poses.device) < states.n_active[:, None]
    _, flat = kld.grid_cells(kld.bin_keys(states.poses), act, params.hist_shape)
    gx, gy, ga = params.hist_shape
    return kld.composite_sort(flat, act, gx * gy * ga)[2].sum()


SHARDED_RANKS = 2  # gloo ranks spawned on the one card
RANK_TIMEOUT_S = 300
SHARDED_NOISE_SEED = 12


def sharded_noises(dev, r, m):
    """The 3 steps' global FleetNoise of the sharded-fleet phase, drawn
    from one seeded generator: every rank draws them all and takes its
    rows, as the one-process run uses them whole."""
    import torch

    from badger_amcl_tpu_torch.fleet import FleetNoise

    gen = torch.Generator(device=dev).manual_seed(SHARDED_NOISE_SEED)
    return [FleetNoise.draw(gen, r, m, dev) for _ in range(3)]


def sharded_steps(group, fl, omap, noises):
    """(step, s): the rank's robots of `fl` after `make_sharded_fleet_step`
    on "corr" ran one step per noise (each sliced to the rank's rows), and
    the step with its rank's scans, pools and odometry bound (variates
    from a generator)."""
    from badger_amcl_tpu_torch import fleet
    from badger_amcl_tpu_torch.sensors.planar import PlanarScanParams

    params, states, scans, pools, odom_poses, deltas, alphas = fl
    sp = PlanarScanParams()
    step = fleet.make_sharded_fleet_step(group, params, backend="corr",
                                         n_robots=states.poses.shape[0])
    own = [fleet.shard_robots(x, group) for x in (scans, pools, odom_poses, deltas, deltas)]
    s = fleet.shard_robots(states, group)
    for noise in noises:
        s = step(s, omap, sp, *own, alphas, noise=fleet.shard_robots(noise, group))
    return (lambda gen: lambda x: step(x, omap, sp, *own, alphas, generator=gen)), s


def fleet_rank(rank, world, tmp):
    """One gloo rank of phase_sharded_fleet, in its own process on the one
    card: rebuild the flagship map and the 256-robot fleet from their
    seeds (the initial poses must equal the parent's), capture the rank's
    compiled step, run 3 sharded steps (replays) on this rank's rows of
    the global draws, time pinned steps, and write tmp/rank{rank}.json
    (match with the parent's one-process rows, fleet_corr_table launches
    inside the replays, the capture, the group's health)."""
    import torch

    sys.path.insert(0, ROOT)
    from badger_amcl_tpu_torch import fleet, scenario
    from badger_amcl_tpu_torch.ops import corr_kernel as ck

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    group = fleet.init_fleet_group(f"file://{tmp}/gloo_store", world, rank, backend="gloo")
    try:
        dev = fleet.rank_device(group)
        job = torch.load(f"{tmp}/job.pt", map_location="cpu")
        omap = scenario.build_map(MAP_CELLS, device=dev)
        fl = scenario.build_fleet(FLEET_ROBOTS, FLEET_PARTICLES, FLEET_BEAMS, device=dev)
        params, states = fl[0], fl[1]
        check(torch.equal(states.poses.cpu(), job["init_poses"]),
              f"rank {rank}: the rebuilt fleet differs from the parent's")
        r, m = states.weights.shape
        noises = sharded_noises(dev, r, m)
        graph = fleet.make_fleet_step(params).graph
        graph.kernels.update(fleet_counters())
        # the rank's key captured first, so the counted steps are replays
        sharded_steps(group, fl, omap, noises[:1])
        counts = Launches({"fleet_corr_table": ck.fleet_corr_table}, [graph])
        box = {}

        def run():
            box["bind"], box["s"] = sharded_steps(group, fl, omap, noises)
            torch.cuda.synchronize()

        launches = counts.run(run, len(noises))["fleet_corr_table"]
        bind, s = box["bind"], box["s"]
        entry = next(iter(graph.entries.values()))
        rows = slice(rank * (r // world), (rank + 1) * (r // world))
        close = ((s.poses.cpu() - job["want_poses"][rows]).abs() <= 1e-5).all(-1)
        health = {k: float(v) for k, v in fleet.fleet_health(s, group).items()}
        step, _ = pinned_step_fn(bind(torch.Generator(device=dev).manual_seed(rank)), s,
                                 params.max_samples)
        ms = cuda_ms(step, iters=10, warmup=2)
        out = dict(rank=rank, robots=s.poses.shape[0], launches=launches, steps=len(noises),
                   captures=graph.captures, capture_s=entry.capture_s, graph_nodes=entry.nodes,
                   poses_within_1e5=close.float().mean().item(),
                   n_active_equal=torch.equal(s.n_active.cpu(), job["want_n_active"][rows]),
                   health=health, step_ms=ms)
        with open(f"{tmp}/rank{rank}.json", "w") as f:
            json.dump(out, f)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def phase_sharded_fleet(dev, omap, fl):
    """The sharded fleet (`make_sharded_fleet_step`, `fleet_health(group)`)
    at 256 x 10,000 x 180, each rank's step the compiled one: (i) one NCCL
    rank in this process (a file store in a temporary directory): 3 steps
    with motion on the one-process run's variates must equal the
    one-process compiled step bit for bit (which must equal `fleet_step`'s
    poses and n_active), the NCCL health equal the local one (rtol 1e-6),
    #5 launch once a step inside the replays; (ii) two gloo ranks spawned
    on the one card (NCCL refuses two ranks on one device, so gloo is this
    test's choice), 128 robots each, each capturing its own graph: each
    rank's robots against its rows of the one-process run (n_active
    equal, >= 99.9% of particles within 1e-5), #5 inside every step's
    replay, the group's health equal to the whole fleet's, and per-rank
    step ms of two processes sharing one card. Returns (launch counts of
    (i), timings)."""
    import tempfile

    import torch

    from badger_amcl_tpu_torch import fleet
    from badger_amcl_tpu_torch.ops import cluster_kernel as clk
    from badger_amcl_tpu_torch.ops import corr_kernel as ck
    from badger_amcl_tpu_torch.sensors.planar import PlanarScanParams

    params, states = fl[0], fl[1]
    r, m = states.weights.shape
    noises = sharded_noises(dev, r, m)
    one = states
    for noise in noises:
        one = fleet_step_fn(fl, omap, None, noise)(one)
    # the one-process compiled step on the same draws
    compiled_step = fleet.make_fleet_step(params, backend="corr")
    _, _, scans, pools, odom_poses, deltas, alphas = fl
    one_c = states
    for noise in noises:
        one_c = compiled_step(one_c, omap, PlanarScanParams(), scans, pools, odom_poses, deltas,
                              deltas, alphas, noise=noise)
    check(torch.equal(one_c.poses, one.poses) and torch.equal(one_c.n_active, one.n_active),
          "sharded fleet: the one-process compiled step differs from fleet_step")
    want = {k: float(v) for k, v in fleet.fleet_health(one).items()}
    counts = Launches({"cluster_labels": clk.cluster_labels,
                       "fleet_corr_table": ck.fleet_corr_table}, [compiled_step.graph])
    with tempfile.TemporaryDirectory() as tmp:
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        group = fleet.init_fleet_group(f"file://{tmp}/nccl_store", 1, 0, device="cuda")
        try:
            box = {}

            def run():
                box["s"] = sharded_steps(group, fl, omap, noises)[1]
                torch.cuda.synchronize()

            rose = counts.run(run, len(noises))
            s = box["s"]
            health = fleet.fleet_health(s, group)
        finally:
            torch.distributed.destroy_process_group()
        check(rose["fleet_corr_table"] == len(noises),
              f"sharded fleet (NCCL): #5 launched {rose['fleet_corr_table']} times in "
              f"{len(noises)} steps")
        for f in ("poses", "weights", "n_active", "converged"):
            check(torch.equal(getattr(s, f), getattr(one_c, f)),
                  f"sharded fleet (NCCL): the one-rank compiled step's {f} differs from the "
                  f"one-process compiled step's")
        check(counts.replayed["fleet_corr_table"] == len(noises),
              "sharded fleet (NCCL): #5 did not launch inside the replays")
        check(all(v.device.type == "cuda" for v in health.values()),
              "sharded fleet (NCCL): the health was not reduced on the card")
        for k, v in health.items():
            check(math.isclose(float(v), want[k], rel_tol=1e-6),
                  f"sharded fleet (NCCL): {k} {float(v)} vs {want[k]}")
        log(f"sharded fleet in process (1 NCCL rank, {r} x {m} x {FLEET_BEAMS}, 3 compiled "
            f"steps): bit-equal to the one-process compiled step, which equals fleet_step "
            f"(poses, n_active); #5 launches inside replays {rose['fleet_corr_table']}, health "
            f"{ {k: round(float(v), 6) for k, v in health.items()} }")

        torch.save(dict(init_poses=states.poses.cpu(), want_poses=one.poses.cpu(),
                        want_n_active=one.n_active.cpu()), f"{tmp}/job.pt")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH",
                                                                                 "")]))
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--fleet-rank",
                                   str(rank), str(SHARDED_RANKS), tmp], env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for rank in range(SHARDED_RANKS)]
        errs = []
        try:
            for p in procs:
                errs.append(p.communicate(timeout=RANK_TIMEOUT_S)[1])
        except subprocess.TimeoutExpired:
            raise Failure(f"sharded fleet: a gloo rank ran past {RANK_TIMEOUT_S} s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        for rank, (p, err) in enumerate(zip(procs, errs)):
            check(p.returncode == 0, f"sharded fleet: gloo rank {rank} exited {p.returncode}:\n"
                                     f"{err[-4000:]}")
        ranks = []
        for rank in range(SHARDED_RANKS):
            with open(f"{tmp}/rank{rank}.json") as f:
                ranks.append(json.load(f))
    for out in ranks:
        tag = f"sharded fleet: gloo rank {out['rank']}"
        check(out["launches"] == out["steps"], f"{tag}: #5 launched {out['launches']} times in "
                                               f"{out['steps']} steps' replays")
        check(out["captures"] == 1, f"{tag}: {out['captures']} captures of its one key")
        check(out["n_active_equal"], f"{tag}: n_active differs from the one-process run")
        check(out["poses_within_1e5"] >= 0.999,
              f"{tag}: only {out['poses_within_1e5']:.4f} of poses within 1e-5")
        for k, v in out["health"].items():
            check(math.isclose(v, want[k], rel_tol=1e-6), f"{tag}: {k} {v} vs {want[k]}")
        out["robot_steps_per_s"] = out["robots"] / (out["step_ms"] / 1e3)
        log(f"sharded fleet gloo rank {out['rank']} of {SHARDED_RANKS} ({out['robots']} robots "
            f"x {m} x {FLEET_BEAMS}; two processes sharing one card, not a scaling figure): "
            f"compiled (1 capture, {out['capture_s']:.2f} s, {out['graph_nodes']} graph "
            f"nodes), poses within 1e-5 {out['poses_within_1e5']:.4f}, n_active equal, #5 "
            f"inside replays {out['launches']}/{out['steps']}, step_ms {out['step_ms']:.4f}, "
            f"robot_steps_per_s {out['robot_steps_per_s']:.1f}")
    log(f"sharded fleet: {SHARDED_RANKS} gloo ranks in {wall:.1f} s wall (start-up included)")
    return counts.read(), dict(ranks=ranks, wall_s=wall, health=want)


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
    """The 3D kernels against their plain versions at the main path's
    shapes: the window prepass on the steady, tracking and spread clouds
    (extents equal, so origins and fits too), the windowed arm's fused
    sums and the (B, M) distances on the steady and tracking clouds, the
    spread sums on the spread and tracking clouds."""
    import torch

    from badger_amcl_tpu_torch.ops import pc_kernel as pk
    from badger_amcl_tpu_torch.ops import pc_spread_kernel as psk
    from badger_amcl_tpu_torch.sensors import point_cloud as pc

    results = {}
    nx, ny, nz = omap.size
    tex_bytes = nx * ny * nz
    n_pts = cloud.shape[0]
    pcp = pc.PointCloudParams()
    kz = pk.point_slabs(omap, cloud)

    rows = []
    for regime in ("steady", "tracking", "spread"):
        poses = states[regime][1].poses
        m = poses.shape[0]
        ext = pk.pc_extents(omap, cloud, poses)
        ext_plain = pk.pc_extents_plain(omap, cloud, poses)
        torch.cuda.synchronize()
        err = int((ext.long() - ext_plain.long()).abs().max())
        check(torch.equal(ext, ext_plain),
              f"pc_extents ({regime}): {int((ext != ext_plain).sum())} extents differ from "
              f"the plain version (max {err})")
        r0, c0, _, fits = pk.window_finish(omap, ext, kz)
        r0_p, c0_p, _, fits_p = pk.window_finish(omap, ext_plain, kz)
        check(bool(fits) == bool(fits_p) == (regime == "steady")
              and torch.equal(r0, r0_p) and torch.equal(c0, c0_p),
              f"pc prepass ({regime}): fits {bool(fits)} / plain {bool(fits_p)}, origins "
              f"equal {torch.equal(r0, r0_p) and torch.equal(c0, c0_p)}")
        ms = cuda_ms(lambda: pk.window_origins(omap, cloud, poses))
        dev = kernel_ms(lambda: pk.pc_extents(omap, cloud, poses))
        plain_ms = cuda_ms(lambda: pk.window_finish(
            omap, pk.pc_extents_plain(omap, cloud, poses), kz))
        # 16 operations per (particle, point): the cell (12), 4 min/max;
        # cos and sin per particle
        b = bound(m * 12 + n_pts * 12 + 4 * n_pts * 4, 16.0 * m * n_pts + 2.0 * m)
        log(f"pc prepass ({regime}, {n_pts} x {m}): extents equal, fits={bool(fits)} "
            f"ms={ms:.4f} (extents + finish) device_ms={device_text(dev)} "
            f"({'; '.join(f'{n} {t:.4f}' for n, t in dev.items())}) plain_ms={plain_ms:.4f} "
            f"bound_ms={b['bound_ms']:.5f} ({b['bound_by']})")
        rows.append((err, ms, plain_ms, b, device_ms(dev)))
    results["pc_extents"] = dict(max_abs_err=max(r[0] for r in rows), ms=rows[0][1],
                                 device_ms=rows[0][4], plain_ms=rows[0][2], **rows[0][3],
                                 library_ms=None)

    rows = []
    for regime in ("steady", "tracking"):
        poses = states[regime][1].poses
        m = poses.shape[0]
        # the voxels the cloud reads: each read once for the bound
        ci, cj = pk._cells(omap, cloud, poses)
        inmap = pk._on_map(omap, ci, cj) & ((kz >= 0) & (kz < nz))[:, None]
        voxels = int(omap.flat_index(ci, cj, kz[:, None].expand_as(ci))[inmap].unique().numel())
        del ci, cj, inmap
        for model in MODELS_3D:
            term, _, _ = pc._model_term_finalize(omap, pcp, model, n_pts)
            got = pk.pc_term_sums(omap, cloud, poses, term)
            want = pk.pc_term_sums_plain(omap, cloud, poses, term)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            rel = float(((got - want).abs() / want.abs().clamp(min=1e-30)).max())
            check(rel <= 1e-5, f"pc_term_sums ({regime}, {model}) rel err {rel} > 1e-5")
            ms = cuda_ms(lambda: pk.pc_term_sums(omap, cloud, poses, term))
            dev = kernel_ms(lambda: pk.pc_term_sums(omap, cloud, poses, term))
            plain_ms = cuda_ms(lambda: pk.pc_term_sums_plain(omap, cloud, poses, term))
            # 16 operations per (particle, point): the cell (12), the
            # bounds test, the table read's index, the add; nothing (B, M)
            b = bound(voxels + m * 12 + n_pts * 12 + m * 4 + 257 * 4, 16.0 * m * n_pts)
            log(f"pc_term_sums ({regime}, {model}, {n_pts} x {m}): max_abs_err={err:.3e} "
                f"max_rel_err={rel:.3e} ms={ms:.4f} (wrapper) device_ms={device_text(dev)} "
                f"plain_ms={plain_ms:.4f} bound_ms={b['bound_ms']:.5f} ({b['bound_by']}; "
                f"{voxels} voxels read)")
            rows.append((err, ms, plain_ms, b, device_ms(dev), regime, model, m))
    # reported: the steady cloud under the 3D default (Gompertz) model, and
    # beside it every cloud and model
    results["pc_term_sums"] = dict(
        max_abs_err=max(r[0] for r in rows), ms=rows[1][1], device_ms=rows[1][4],
        plain_ms=rows[1][2], **rows[1][3], library_ms=None,
        by_cloud=[{"cloud": r[5], "model": r[6], "particles": r[7], "ms": r[1],
                   "device_ms": r[4], "plain_ms": r[2], "bound_ms": r[3]["bound_ms"]}
                  for r in rows])

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
        ops = kernel_ms(lambda: pk.pc_distances(omap, cloud, poses))
        plain_ms = cuda_ms(lambda: pk.pc_distances_plain(omap, cloud, poses))
        m = poses.shape[0]
        # 13 f32 operations per (point, particle), cos and sin per particle
        b = bound(got.numel() * 4 + tex_bytes + m * 12 + n_pts * 12,
                  13.0 * got.numel() + 2.0 * m)
        log(f"pc_distances ({regime}, {n_pts} x {m}): bit_equal={eq:.6f} "
            f"max_abs_err={err:.3e} ms={ms:.4f} (wrapper) device_ms={device_text(ops)} "
            f"plain_ms={plain_ms:.4f} bound_ms={b['bound_ms']:.5f} ({b['bound_by']})")
        rows.append((err, ms, plain_ms, b, device_ms(ops)))
        del got, want, diff
    results["pc_distances"] = dict(max_abs_err=max(r[0] for r in rows), ms=rows[0][1],
                                   device_ms=rows[0][4], plain_ms=rows[0][2], **rows[0][3],
                                   library_ms=None)

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
            dev = kernel_ms(lambda: psk.pc_spread_term_sums(omap, poses, cloud, term))
            plain_ms = cuda_ms(lambda: psk.pc_spread_term_sums_plain(omap, *inputs, term))
            # the table form: 12 operations per (particle, point), the
            # endpoint (8), two floors, the bounds test, the add; beside it
            # the per-pair term's count, 17 with the cube (15 without)
            b = bound(tex_bytes + m * 12 + n_pts * 12 + m * 4 + 257 * 4, 12.0 * m * n_pts)
            b_term = bound(tex_bytes + m * 12 + n_pts * 12 + m * 4,
                           (17.0 if term.cube else 15.0) * m * n_pts)
            log(f"pc_spread_term_sums ({regime}, {model}, {n_pts} x {m}): "
                f"max_abs_err={err:.3e} max_rel_err={rel:.3e} ms={ms:.4f} (wrapper) "
                f"device_ms={device_text(dev)} "
                f"({'; '.join(f'{n} {t:.4f}' for n, t in dev.items())}) "
                f"plain_ms={plain_ms:.4f} bound_ms={b['bound_ms']:.5f} ({b['bound_by']}; "
                f"the per-pair term's {b_term['bound_ms']:.5f})")
            rows.append((err, ms, plain_ms, b, device_ms(dev), regime, model, m))
    # reported: the spread cloud under the 3D default (Gompertz) model, and
    # beside it every cloud and model
    results["pc_spread_term_sums"] = dict(
        max_abs_err=max(r[0] for r in rows), ms=rows[1][1], device_ms=rows[1][4],
        plain_ms=rows[1][2], **rows[1][3], library_ms=None,
        by_cloud=[{"cloud": r[5], "model": r[6], "particles": r[7], "ms": r[1],
                   "device_ms": r[4], "plain_ms": r[2], "bound_ms": r[3]["bound_ms"]}
                  for r in rows])
    return results


def phase_main_path_3d(dev, omap, cloud, states):
    """Drive the 3D path for both models in every regime; returns the
    per-kernel launch counts of this run only."""
    import torch

    from badger_amcl_tpu_torch.ops import cluster_kernel as clk
    from badger_amcl_tpu_torch.ops import pc_kernel as pk
    from badger_amcl_tpu_torch.ops import pc_spread_kernel as psk
    from badger_amcl_tpu_torch.scenario import TRUE_POSE_3D
    from badger_amcl_tpu_torch.sensors.point_cloud import PointCloudParams

    # the tracking cloud (cov 0.02) spans more than the windowed kernel's
    # 64-row window, so the JAX dispatch and the port send it to pc_spread;
    # every regime runs the window prepass (the dispatch predicate)
    expect = {"steady": "pc_term_sums", "tracking": "pc_spread_term_sums",
              "spread": "pc_spread_term_sums"}
    pcp = PointCloudParams()
    counts = Launches({"cluster_labels": clk.cluster_labels, "pc_term_sums": pk.pc_term_sums,
                       "pc_extents": pk.pc_extents, "pc_distances": pk.pc_distances,
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
            check(rose["pc_extents"] > 0, f"3d {regime}/{model}: the window prepass was not "
                                          "launched")
            # the windowed arm: the fused sums; nothing (B, M)
            check(rose["pc_distances"] == 0, f"3d {regime}/{model}: the (B, M) pc_distances "
                                             f"launched {rose['pc_distances']} times")
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
    for regime, kernel in (("steady", pk.pc_term_sums),
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


# --- map set-up: the distance fields at map receipt -------------------------

STORE_RES = 0.05
STORE_GRID = (2000, 1200)  # ROS grid (width, height): 100 x 60 m at 0.05 m
STORE_VOXELS = (2000, 1200, 50)  # 100 x 60 x 2.5 m at 0.05 m
STORE_MARGIN = 20  # unknown cells outside the 2D store's walls
STORE_SHELF_VOXELS = 36  # gondola faces 1.8 m high
STORE_PARTICLES = 50_000
STORE_STEPS = 3
STORE_POSE = (30.0, 9.2, 0.0)  # in the first aisle, world metres of both maps
SPOT_VOXELS = 65_536
SPOT_BLOCK = 64


def store_gondolas(w, h, seed):
    """Gondola rows of the store's plan in cells of STORE_RES, as (x0, x1,
    y0, y1) half-open boxes: rows along x 1.2 m deep with 2 m aisles,
    behind a 6 m front area, split by 3 m cross aisles every ~19 m
    (seeded lengths)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    m, rows = STORE_MARGIN, []
    y = m + 120
    while y + 24 < h - m - 60:
        x = m + 100
        while x < w - m - 160:
            x1 = min(x + int(rng.integers(340, 420)), w - m - 100)
            rows.append((x, x1, y, y + 24))
            x = x1 + 60
        y += 24 + 40
    return rows


def store_grid(w, h, seed=0):
    """The seeded (h, w) int8 ROS occupancy grid of the store (0 free, 100
    occupied, -1 unknown), as a lidar map shows it: 2-cell outer walls
    STORE_MARGIN cells inside the grid, unknown outside them; each gondola's
    faces occupied and its inside unknown; 40 pallets of 1 m in the front
    area; single-cell clutter on 0.02% of the free cells."""
    import numpy as np

    rng = np.random.default_rng(seed + 1)
    m = STORE_MARGIN
    g = np.full((h, w), -1, np.int8)
    g[m:h - m, m:w - m] = 0
    g[m:m + 2, m:w - m] = g[h - m - 2:h - m, m:w - m] = 100
    g[m:h - m, m:m + 2] = g[m:h - m, w - m - 2:w - m] = 100
    for x0, x1, y0, y1 in store_gondolas(w, h, seed):
        g[y0:y1, x0:x1] = -1
        g[y0, x0:x1] = g[y1 - 1, x0:x1] = g[y0:y1, x0] = g[y0:y1, x1 - 1] = 100
    for _ in range(40):
        px, py = rng.integers(m + 10, w - m - 30), rng.integers(m + 10, m + 100)
        g[py:py + 20, px:px + 20] = 100
    g[(g == 0) & (rng.random((h, w)) < 2e-4)] = 100
    return g


def store_voxels(nx, ny, nz, seed=0):
    """(K, 3) int64 occupied voxel cells of the store volume: the floor
    plane, the four outer walls to full height at the volume's edges, and
    the gondolas' faces to STORE_SHELF_VOXELS with seeded gaps (a missing
    face column, 10%)."""
    import numpy as np

    rng = np.random.default_rng(seed + 2)
    gx, gy = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    parts = [np.stack([gx.ravel(), gy.ravel(), np.zeros(nx * ny, np.int64)], axis=1)]
    rim = (gx == 0) | (gx == nx - 1) | (gy == 0) | (gy == ny - 1)
    faces = np.zeros((nx, ny), bool)
    for x0, x1, y0, y1 in store_gondolas(nx, ny, seed):
        faces[x0:x1, y0] = faces[x0:x1, y1 - 1] = faces[x0, y0:y1] = faces[x1 - 1, y0:y1] = True
    faces &= rng.random((nx, ny)) >= 0.1
    for mask, top in ((rim, nz), (faces, min(STORE_SHELF_VOXELS, nz))):
        xs, ys = np.nonzero(mask)
        zs = np.arange(1, top)
        parts.append(np.stack([np.repeat(xs, len(zs)), np.repeat(ys, len(zs)),
                               np.tile(zs, len(xs))], axis=1))
    return np.concatenate(parts)


def numpy_texture(vol_zyx, res, max_dist):
    """The numpy exact EDT of a (nz, ny, nx) occupancy volume in the JAX
    package's (x, y, z) layout, quantized as octomap_3d.py:136-141 does;
    returned (nz, ny, nx)."""
    import numpy as np

    from badger_amcl_tpu_torch.maps import edt

    d_m = np.minimum(edt.edt_3d(np.ascontiguousarray(vol_zyx.transpose(2, 1, 0)) != 0) * res,
                     max_dist)
    return np.floor(d_m / max_dist * 255.0).astype(np.uint8).transpose(2, 1, 0)


def scipy_seconds(free):
    """Host seconds of scipy.ndimage.distance_transform_edt (the distance
    to the nearest False) on a bool array, or None without scipy."""
    try:
        from scipy import ndimage
    except ImportError:
        return None
    t0 = time.perf_counter()
    ndimage.distance_transform_edt(free)
    return time.perf_counter() - t0


def numpy_edt_importers():
    """The port's modules, maps/edt.py aside, that import the numpy EDT
    (maps/edt.py): a map receipt can reach it only through one of them."""
    import ast

    pkg, own = os.path.join(ROOT, "badger_amcl_tpu_torch"), os.path.join("maps", "edt.py")
    found = []
    for dirpath, _, files in os.walk(pkg):
        for f in sorted(files):
            path = os.path.join(dirpath, f)
            if not f.endswith(".py") or os.path.relpath(path, pkg) == own:
                continue
            with open(path) as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                if not isinstance(node, (ast.Import, ast.ImportFrom)):
                    continue
                names = [a.name for a in node.names]
                if (any(n.endswith("maps.edt") for n in names) or "edt" in names
                        or (getattr(node, "module", None) or "").split(".")[-1] == "edt"):
                    found.append(os.path.relpath(path, ROOT))
                    break
    return found


def brute_texture(vol, idx, r, res, max_dist, chunk=4096):
    """The uint8 texture at the (S, 3) (z, y, x) voxels `idx` of a (nz, ny,
    nx) occupancy volume by brute force on the card: the least squared
    offset to an occupied voxel of the (2r + 1)^3 cube around each, then
    the reference's quantization (a voxel with none in its cube is beyond
    r, so reads 255)."""
    import torch

    from badger_amcl_tpu_torch.utils.numerics import fdiv

    dev, shape = vol.device, torch.tensor(vol.shape, device=vol.device)
    o = torch.arange(-r, r + 1, device=dev)
    offs = torch.cartesian_prod(o, o, o)
    d2o = (offs * offs).sum(dim=1)
    flat_vol = vol.reshape(-1)
    out = []
    for s in range(0, idx.shape[0], chunk):
        p = idx[s:s + chunk, None, :] + offs[None]
        inb = ((p >= 0) & (p < shape)).all(dim=-1)
        p = torch.minimum(p.clamp(min=0), shape - 1)
        hit = (flat_vol[(p[..., 0] * vol.shape[1] + p[..., 1]) * vol.shape[2] + p[..., 2]] != 0) \
            & inb
        d2 = torch.where(hit, d2o[None], 1 << 30).min(dim=1).values
        d = torch.sqrt(d2.to(torch.float64))
        out.append(torch.floor(fdiv(torch.clamp(d * res, max=max_dist), max_dist) * 255.0)
                   .to(torch.uint8))
    return torch.cat(out)


def edt_figures(label, fn, plain_fn, n, axes, design_bytes, bytes_io, numpy_s, scipy_s,
                iters=ITERS):
    """The kernel's wrapper ms (CUDA events), profiled device ms, the plain
    version's ms on the card and the bound of one EDT call over n cells on
    `axes` axes: the input read once and the output written once, and the
    int32 operations of two linear sweeps a cell per axis (an add and a
    min each), whatever the design. The design's int32 intermediates give
    a byte floor that is logged and kept in the timings only."""
    ms = cuda_ms(fn, iters=iters)
    dev = kernel_ms(fn)
    plain_ms = cuda_ms(plain_fn, iters=3, warmup=1)
    b = bound(bytes_io, 4.0 * axes * n, INT32_OPS_PER_S)
    floor_ms = design_bytes / HBM_BYTES_PER_S * 1e3
    log(f"{label}: ms={ms:.4f} (wrapper) device_ms={device_text(dev)} "
        f"({'; '.join(f'{k} {t:.4f}' for k, t in dev.items())}) plain_ms={plain_ms:.4f} "
        f"bound_ms={b['bound_ms']:.5f} ({b['bound_by']}; the design's intermediates "
        f"{floor_ms:.4f}) numpy_s={'not run' if numpy_s is None else f'{numpy_s:.4f}'} "
        f"scipy_s={'not run' if scipy_s is None else f'{scipy_s:.4f}'}")
    return dict(ms=ms, device_ms=device_ms(dev), plain_ms=plain_ms, **b,
                library_ms=None), dict(design_floor_ms=floor_ms, numpy_s=numpy_s,
                                       scipy_s=scipy_s)


def timed(fn):
    """(fn(), its wall seconds up to a CUDA synchronise)."""
    import torch

    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def store_steps(label, state, step_fn, counters, smi):
    """STORE_STEPS steps of `step_fn` from `state` (each synchronised, the
    kernels it launched and so the arm it took), then the device busy of
    as many pinned steps from the same state."""
    import torch

    rows, s = [], state
    for _ in range(STORE_STEPS):
        for c in counters.values():
            c.launches = 0
        s, sec = timed(lambda: step_fn(s))
        launched = {k: c.launches for k, c in counters.items() if c.launches}
        rows.append(dict(step_ms=sec * 1e3, launched=launched))
    step, _ = pinned_step_fn(step_fn, state, state.poses.shape[0])
    busy_ms, ops, top = device_busy(step, steps=STORE_STEPS)
    step_ms = statistics.median(r["step_ms"] for r in rows)
    log(f"map_setup steps {label} ({smi}): step_ms {[round(r['step_ms'], 4) for r in rows]} "
        f"(median {step_ms:.4f}, host clock, synchronised); kernels launched per step "
        f"{[r['launched'] or 'none' for r in rows]}; device busy ms per "
        f"step {busy_ms:.4f}, ops {ops:.0f}, idle share {1.0 - busy_ms / step_ms:.3f}; top "
        + "; ".join(f"{n} {t:.4f}" for n, t in top))
    check(bool(torch.isfinite(s.weights).all()) and bool(torch.isfinite(s.poses).all()),
          f"map_setup steps {label}: non-finite state")
    return dict(steps=rows, step_ms_median=step_ms, device_busy_ms=busy_ms,
                device_ops_per_step=ops, device_idle_share=1.0 - busy_ms / step_ms,
                top_device_ops=top)


def phase_map_setup(dev, smi):
    """The maps' distance fields at map receipt, on store-sized maps
    through the nodes' entry points: a seeded 2000 x 1200 ROS grid of a
    100 x 60 m store through `Node2D.map_msg_received` with
    examples/amcl_2d.yaml (supersampled to 4000 x 2400 at 0.025 m, 0.36 m
    cap), each stage timed, the field bit-equal to the numpy
    `capped_distance_field` and to the plain version; the 2000 x 1200 x 50
    voxel store through `Node3D.octomap_msg_received` with
    examples/amcl_3d.yaml (0.3 m), the texture equal to the plain version
    and to a brute-force minimum on the card at 65,536 random voxels and
    every voxel of one 64 x 64 x nz block. No port module but maps/edt.py
    may import the numpy EDT, so the receipts cannot reach it. Kernel, plain, numpy and scipy times, bounds and
    peak device memory per map; then, as measurements, STORE_STEPS steps of
    50,000 particles on each map above the texture gates (2D corr from the
    tracking and the spread covariance, 3D Gompertz from the tracking one):
    the arm each step takes, step ms and device busy. Returns (the path's
    launch counts, kernels-line entries, timings)."""
    import tempfile

    import numpy as np
    import torch

    from badger_amcl_tpu_torch import cli, scenario
    from badger_amcl_tpu_torch.maps import edt
    from badger_amcl_tpu_torch.maps.occupancy_2d import CellState, OccupancyMap2D
    from badger_amcl_tpu_torch.maps.octomap_3d import OctoMap3D
    from badger_amcl_tpu_torch.node import TransformBuffer, make_node
    from badger_amcl_tpu_torch.node.messages import OccupancyGrid, OctomapMsg
    from badger_amcl_tpu_torch.ops import cluster_kernel as clk
    from badger_amcl_tpu_torch.ops import corr_kernel, lf_kernel, pc_kernel, pc_spread_kernel
    from badger_amcl_tpu_torch.ops import edt_kernel as ek
    from badger_amcl_tpu_torch.ops import spread_kernel
    from badger_amcl_tpu_torch.sensors import planar
    from badger_amcl_tpu_torch.sensors.point_cloud import PointCloudParams

    importers = numpy_edt_importers()
    check(not importers, f"map_setup: {importers} import the numpy EDT")
    log("map_setup: no port module but maps/edt.py imports the numpy EDT")
    counts = Launches({"cluster_labels": clk.cluster_labels, "edt_2d": ek.capped_field_2d,
                       "edt_3d": ek.voxel_texture_3d})
    kernels, timing = {}, {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        # the 2D store
        w, h = STORE_GRID
        t0 = time.perf_counter()
        grid = store_grid(w, h)
        msg = OccupancyGrid(width=w, height=h, resolution=STORE_RES, origin_x=0.0,
                            origin_y=0.0, data=grid.ravel())
        make_s = time.perf_counter() - t0
        cfg = cli.load_config(os.path.join(ROOT, "examples", "amcl_2d.yaml")).replace(
            save_pose=False, saved_pose_filepath=os.path.join(tmp, "saved_pose.yaml"))
        md, s = cfg.laser_likelihood_max_dist, cfg.map_scale_up_factor
        omap, grid_s = timed(lambda: OccupancyMap2D.from_occupancy_grid_msg(
            w, h, STORE_RES, 0.0, 0.0, msg.data, s, device=dev))
        lut, field_s = timed(lambda: ek.capped_field_2d(omap.cells, omap.resolution, md))
        omap, bakes_s = timed(lambda: dataclasses.replace(
            omap, distances=lut, max_distance_to_object=md).with_distance_bakes())
        _, free_s = timed(lambda: omap.free_space_indices(cfg.laser_non_free_space_radius))
        tf = TransformBuffer()
        node = make_node(cfg, tf_buffer=tf, device=dev)
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        counts.run(lambda: timing.setdefault("2d_receipt_s", timed(
            lambda: node.map_msg_received(msg))[1]), 1)
        peak = torch.cuda.max_memory_allocated()
        cells, got = node.map.cells, node.map.distances
        check(tuple(got.shape) == (h * s, w * s) and node.map.resolution == STORE_RES / s,
              f"map_setup 2D: field {tuple(got.shape)} at {node.map.resolution}")
        occ = cells.cpu().numpy() == int(CellState.OCCUPIED)
        t0 = time.perf_counter()
        want = edt.capped_distance_field(occ, node.map.resolution, md)
        numpy_s = time.perf_counter() - t0
        plain = ek.capped_field_2d_plain(cells, node.map.resolution, md)
        err = float((got - plain).abs().max())
        check(torch.equal(got, plain), f"map_setup 2D: kernel != plain ({err})")
        n_bad = int((got.cpu().numpy() != want).sum())
        check(n_bad == 0, f"map_setup 2D: {n_bad} cells differ from the numpy field")
        r = ek.window_2d(node.map.resolution, md)
        n = cells.numel()
        fig, extra = edt_figures(
            f"edt_2d ({h * s} x {w * s} store field, R {r})",
            lambda: ek.capped_field_2d(cells, node.map.resolution, md),
            lambda: ek.capped_field_2d_plain(cells, node.map.resolution, md), n, 2,
            13 * n, 5 * n, numpy_s, scipy_seconds(~occ))
        kernels["edt_2d"] = dict(max_abs_err=err, **fig)
        timing["2d"] = dict(
            grid=[w, h], field=[w * s, h * s], resolution=node.map.resolution,
            max_dist=md, window=r, occupied_cells=int(occ.sum()), make_grid_s=make_s,
            grid_upload_s=grid_s, field_s=field_s, bakes_s=bakes_s, free_space_s=free_s,
            receipt_s=timing.pop("2d_receipt_s"), peak_gb=peak / 1e9,
            before_gb=before / 1e9, **fig, **extra)
        log(f"map_setup 2D store ({smi}): {w} x {h} grid at {STORE_RES} m made in "
            f"{make_s:.4f} s -> {w * s} x {h * s} at {node.map.resolution} m, "
            f"{int(occ.sum())} occupied; stages: grid + upload {grid_s:.4f} s, field "
            f"{field_s:.4f} s, bakes {bakes_s:.4f} s, free-space indices {free_s:.4f} s; "
            f"the node's receipt {timing['2d']['receipt_s']:.4f} s; peak device memory "
            f"{peak / 1e9:.3f} GB ({before / 1e9:.3f} before); bit-equal to the numpy field "
            f"({numpy_s:.4f} s) and the plain version")

        # steps above the texture gates (measurement only)
        smap = planar.bake_factor_texture(planar.bake_corr_texture(
            node.map, planar.PlanarScanParams(), scenario.RANGE_MAX, "likelihood_field"),
            planar.PlanarScanParams())
        angles = np.linspace(-2.35, 2.35, N_BEAMS).astype(np.float32)
        ls = scenario.laser_scan(smap, STORE_POSE, angles, 0.0)
        scan = planar.PlanarScan(ranges=torch.as_tensor(ls.ranges, device=dev),
                                 angles=torch.as_tensor(angles, device=dev),
                                 range_max=ls.range_max)
        sp = planar.PlanarScanParams()
        gen = torch.Generator(device=dev).manual_seed(5)
        lf_counters = {"corr_table": corr_kernel.corr_table,
                       "spread_term_sums": spread_kernel.spread_term_sums,
                       "lf_term_sums": lf_kernel.lf_term_sums,
                       "lf_extents": lf_kernel.beam_extents}
        gates = dict(spread_tex_fits=spread_kernel.tex_fits(smap),
                     corr_map_fits=corr_kernel.map_fits(smap))
        log(f"map_setup steps 2D: {smap.size_x * smap.size_y} cells; spread_kernel.tex_fits "
            f"{gates['spread_tex_fits']} (<= {spread_kernel.MAX_TEX_CELLS}), "
            f"corr_kernel.map_fits {gates['corr_map_fits']}")
        timing["2d_steps"] = dict(gates=gates)
        for regime in ("tracking", "spread"):
            params, state, pool = scenario.build_filter(
                STORE_PARTICLES, pose_cov=REGIMES[regime], min_particles=STORE_PARTICLES,
                pose_mean=STORE_POSE, device=dev, pool_lo=(0.0, 0.0, -math.pi),
                pool_hi=(w * STORE_RES, h * STORE_RES, math.pi))
            timing["2d_steps"][regime] = store_steps(
                f"2D {regime} ({STORE_PARTICLES} x {N_BEAMS}, corr)", state,
                lambda st: step_2d(st, smap, sp, scan, pool, params, "likelihood_field",
                                   "corr", gen, motion=False), lf_counters, smi)
        del node, omap, lut, smap, cells, got, plain, want, occ, scan
        torch.cuda.empty_cache()

        # the 3D store
        nx, ny, nz = STORE_VOXELS
        t0 = time.perf_counter()
        vox = store_voxels(nx, ny, nz)
        centres = vox.astype(np.float64) * STORE_RES
        make_s = time.perf_counter() - t0
        cfg3 = node3d_config(tmp)
        md3 = cfg3.resolved_cloud_likelihood_max_dist
        omap3, points_s = timed(lambda: OctoMap3D.from_occupied_points(
            centres, STORE_RES, md3, device=dev))
        check(omap3.size == STORE_VOXELS, f"map_setup 3D: size {omap3.size}")
        vol, scatter_s = timed(omap3.occupancy_volume)
        _, field_s = timed(lambda: ek.voxel_texture_3d(vol, STORE_RES, md3))
        _, free_s = timed(omap3.free_space_indices)
        del omap3
        tf3 = TransformBuffer()
        node3 = make_node(cfg3, tf_buffer=tf3, device=dev)
        msg3 = OctomapMsg(resolution=STORE_RES, occupied_centers=centres)
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        counts.run(lambda: timing.setdefault("3d_receipt_s", timed(
            lambda: node3.octomap_msg_received(msg3))[1]), 1)
        peak = torch.cuda.max_memory_allocated()
        tex = node3.map.tex_zyx
        check(tuple(tex.shape) == (nz, ny, nx), f"map_setup 3D: texture {tuple(tex.shape)}")
        plain = ek.voxel_texture_3d_plain(vol, STORE_RES, md3)
        err = float((tex.int() - plain.int()).abs().max())
        check(torch.equal(tex, plain), f"map_setup 3D: kernel != plain ({err})")
        del plain
        r = ek.window_3d(STORE_RES, md3)
        g = torch.Generator(device=dev).manual_seed(7)
        shape = torch.tensor([nz, ny, nx], device=dev)
        rand = (torch.rand((SPOT_VOXELS, 3), generator=g, device=dev) * shape).long()
        x0, _, y0, _ = store_gondolas(nx, ny, 0)[0]
        bz, by, bx = torch.meshgrid(torch.arange(min(SPOT_BLOCK, nz), device=dev),
                                    torch.arange(y0 - 20, y0 - 20 + SPOT_BLOCK, device=dev),
                                    torch.arange(x0 - 20, x0 - 20 + SPOT_BLOCK, device=dev),
                                    indexing="ij")
        idx = torch.cat([rand, torch.stack([bz.reshape(-1), by.reshape(-1),
                                            bx.reshape(-1)], dim=1)])
        want = brute_texture(vol, idx, r, STORE_RES, md3)
        have = tex[idx[:, 0], idx[:, 1], idx[:, 2]]
        mism = int((want != have).sum())
        below = int((have < 255).sum())
        check(mism == 0, f"map_setup 3D: {mism} of {idx.shape[0]} spot voxels differ from "
                         "the brute-force minimum")
        n = vol.numel()
        fig, extra = edt_figures(
            f"edt_3d ({nz} x {ny} x {nx} store volume, R {r})",
            lambda: ek.voxel_texture_3d(vol, STORE_RES, md3),
            lambda: ek.voxel_texture_3d_plain(vol, STORE_RES, md3), n, 3, 18 * n, 2 * n,
            None, None, iters=10)
        kernels["edt_3d"] = dict(max_abs_err=err, **fig)
        timing["3d"] = dict(
            voxels=list(STORE_VOXELS), resolution=STORE_RES, max_dist=md3, window=r,
            occupied_voxels=len(vox), make_voxels_s=make_s, points_s=points_s,
            scatter_s=scatter_s, field_s=field_s, free_space_s=free_s,
            receipt_s=timing.pop("3d_receipt_s"), peak_gb=peak / 1e9,
            before_gb=before / 1e9, spot_voxels=int(idx.shape[0]), spot_mismatches=mism,
            spot_below_cap=below, **fig, **extra)
        log(f"map_setup 3D store ({smi}): {nx} x {ny} x {nz} voxels at {STORE_RES} m, "
            f"{len(vox)} occupied, made in {make_s:.4f} s; stages: centres -> cells "
            f"{points_s:.4f} s, scatter {scatter_s:.4f} s, texture {field_s:.4f} s, "
            f"free-space indices {free_s:.4f} s; the node's receipt "
            f"{timing['3d']['receipt_s']:.4f} s; peak device memory {peak / 1e9:.3f} GB "
            f"({before / 1e9:.3f} before); equal to the plain version; spot check "
            f"{idx.shape[0]} voxels ({below} below the cap), {mism} mismatches (the numpy "
            "EDT is not run at this size)")

        # the 3D step above the texture gates (measurement only)
        smap3 = node3.map
        pose = np.array(STORE_POSE)
        d = np.hypot(centres[:, 0] - pose[0], centres[:, 1] - pose[1])
        near = centres[(d > 0.5) & (d < 6.0) & (centres[:, 2] > 0.0)]
        sel = near[np.random.default_rng(4).choice(len(near), NODE3D_POINTS, replace=False)]
        c, sn = math.cos(-pose[2]), math.sin(-pose[2])
        rel = sel[:, :2] - pose[:2]
        cloud = torch.as_tensor(np.concatenate(
            [np.stack([c * rel[:, 0] - sn * rel[:, 1], sn * rel[:, 0] + c * rel[:, 1]], 1),
             sel[:, 2:3]], axis=1).astype(np.float32), device=dev)
        gates = dict(pc_tex_fits=pc_kernel.tex_fits(smap3),
                     pc_spread_tex_fits=pc_spread_kernel.tex_fits(smap3))
        log(f"map_setup steps 3D: texture {tex.numel() / 1e6:.1f} MB; pc_kernel.tex_fits "
            f"{gates['pc_tex_fits']}, pc_spread_kernel.tex_fits {gates['pc_spread_tex_fits']} "
            f"(<= {pc_kernel.MAX_TEX_BYTES} bytes)")
        params, state, pool = scenario.build_filter(
            STORE_PARTICLES, pose_cov=REGIMES["tracking"], min_particles=STORE_PARTICLES,
            pose_mean=STORE_POSE, device=dev, pool_lo=(0.0, 0.0, -math.pi),
            pool_hi=(nx * STORE_RES, ny * STORE_RES, math.pi))
        pcp = PointCloudParams()
        gen = torch.Generator(device=dev).manual_seed(6)
        timing["3d_steps"] = dict(gates=gates, tracking=store_steps(
            f"3D tracking ({STORE_PARTICLES} x {NODE3D_POINTS}, Gompertz)", state,
            lambda st: step_3d(st, smap3, pcp, cloud, pool, params,
                               "likelihood_field_gompertz", gen, motion=False),
            {"pc_extents": pc_kernel.pc_extents, "pc_term_sums": pc_kernel.pc_term_sums,
             "pc_spread_term_sums": pc_spread_kernel.pc_spread_term_sums}, smi))
        del node3, smap3, vol, tex, centres, vox
        torch.cuda.empty_cache()
    timing["phase_s"] = time.perf_counter() - t_phase
    log(f"map_setup: the phase took {timing['phase_s']:.1f} s")
    return counts.read(), kernels, timing


# --- 2D node ---------------------------------------------------------------

NODE_SCANS = 30
NODE_WARMUP = 3
NODE_BUSY_SCANS = 6
NODE_GL_SCANS = 4
NODE_MODEL_SCANS = 4
# the scripted true path: per scan 0.25 m along the heading (above the
# default 0.2 m update gate, so every scan updates) and a 0.02 rad turn
NODE_START = (0.0, 0.0, 0.5)
NODE_STEP = (0.25, 0.02)
NODE_REF = (4096, 360, 6)  # card vs CPU: particles, beams, scans
NODE_MODELS = {
    "beam": dict(laser_model_type="beam"),
    "prob_log_beamskip": dict(laser_model_type="likelihood_field_prob",
                              laser_likelihood_log_space=True, do_beamskip=True),
    "pallas_corr_q": dict(compute_backend="pallas_corr_q"),
    "systematic": dict(resample_model_type="systematic"),
}


def node_config(**kw):
    """The port's AMCLConfig at the flagship width: min = max = 50,000
    particles, 720 beams, the scenario's likelihood distance; otherwise the
    defaults."""
    from badger_amcl_tpu_torch import scenario
    from badger_amcl_tpu_torch.config import AMCLConfig

    base = dict(min_particles=N_PARTICLES, max_particles=N_PARTICLES, laser_max_beams=N_BEAMS,
                laser_likelihood_max_dist=scenario.MAX_DIST)
    return AMCLConfig(**{**base, **kw})


class NodeRun:
    """A Node2D built through `make_node` on `dev`, fed the flagship map as
    an OccupancyGrid message and a TransformBuffer with a static
    base->laser, and the (Odometry, scan) stream of a scripted true path
    (per scan `step` = (metres along the heading, radians of turn)), its
    scans raycast on `world` (`scenario.laser_scan`) before they are fed."""

    start, step = NODE_START, NODE_STEP

    def __init__(self, dev, cfg, world, n_scans, n_beams=N_BEAMS, init_cov=None, seed=0):
        from badger_amcl_tpu_torch import scenario

        self.world, self.n_beams = world, n_beams
        self._make(dev, cfg, "laser", init_cov, seed,
                   lambda node: node.map_msg_received(scenario.grid_msg(MAP_CELLS)))
        self.extend(n_scans)

    def _make(self, dev, cfg, scanner_frame, init_cov, seed, receive_map):
        """The node, its TF tree at the start pose and its outputs; the map
        message received (`map_s` its wall seconds)."""
        import numpy as np
        import torch

        from badger_amcl_tpu_torch.node import Transform, TransformBuffer, make_node

        self.base = cfg.base_frame_id
        self.tf = TransformBuffer()
        self.tf.set_static(self.base, scanner_frame, Transform.identity())
        self.node = make_node(cfg, tf_buffer=self.tf, seed=seed, device=dev)
        self.node.init_pose = np.array(self.start)
        if init_cov is not None:
            self.node.init_cov = np.asarray(init_cov, float)
        t0 = time.perf_counter()
        receive_map(self.node)
        if self.node.device.type == "cuda":
            torch.cuda.synchronize()
        self.map_s = time.perf_counter() - t0
        self.out = {k: [] for k in ("amcl_pose", "particlecloud", "tf")}
        for k, v in self.out.items():
            self.node.subscribe_output(k, v.append)
        self.tf.set_transform("odom", self.base, 0.0, Transform.from_pose2d(self.start))
        self.scans, self.truth, self.k = [], [np.array(self.start)], 0

    def make_scan(self, pose, t):
        """The scan at the true pose: `n_beams` ranges raycast on `world`."""
        import numpy as np

        from badger_amcl_tpu_torch import scenario

        angles = np.linspace(-2.35, 2.35, self.n_beams).astype(np.float32)
        return scenario.laser_scan(self.world, pose, angles, t)

    def extend(self, n):
        """Script n more scans along the heading, with odometry equal to the
        true path."""
        import math

        import numpy as np

        from badger_amcl_tpu_torch.node.messages import Odometry

        for _ in range(n):
            pose = self.truth[-1]
            pose = pose + np.array([self.step[0] * math.cos(pose[2]),
                                    self.step[0] * math.sin(pose[2]), self.step[1]])
            t = 0.1 * len(self.truth)
            self.truth.append(pose)
            self.scans.append((Odometry(t, pose.copy()), self.make_scan(pose, t)))

    def feed(self):
        """The next scan's TF, odometry and scan, then spin_once."""
        from badger_amcl_tpu_torch.node import Transform

        odom, scan = self.scans[self.k]
        self.k += 1
        self.tf.set_transform("odom", self.base, odom.stamp, Transform.from_pose2d(odom.pose))
        self.node.integrate_odom(odom)
        self.node.scan_received(scan)
        self.node.spin_once(odom.stamp)

    def pose_error(self):
        """(m, rad) of the last published amcl_pose from the true pose at its
        stamp."""
        import math

        p = self.out["amcl_pose"][-1]
        true = self.truth[int(round(p.stamp / 0.1))]
        return (math.hypot(p.pose[0] - true[0], p.pose[1] - true[1]),
                abs(math.remainder(p.pose[2] - true[2], 2 * math.pi)))


def check_node(run, label):
    """Finite normalized weights and poses, and a finite published pose."""
    import numpy as np
    import torch

    s = run.node.state
    check(bool(torch.isfinite(s.weights).all() & torch.isfinite(s.poses).all()),
          f"{label}: non-finite weights or poses")
    check(abs(float(s.weights.sum()) - 1.0) < 1e-4,
          f"{label}: weights sum {float(s.weights.sum())}")
    check(bool(run.out["amcl_pose"]) and bool(np.isfinite(run.out["amcl_pose"][-1].pose).all()),
          f"{label}: no finite amcl_pose published")


def node_scans(run, n, counts=None):
    """Feed n scans, each CUDA synchronised: [(wall ms, host syncs, whether
    it resampled, its launches, whether it updated the filter)] (launches
    counted when `counts` is given, outside the timed window)."""
    import torch

    from badger_amcl_tpu_torch.utils.numerics import SYNCS

    node, out = run.node, []
    for _ in range(n):
        box = {}

        def scan():
            torch.cuda.synchronize()
            s0, r0 = SYNCS.count, node.resample_count
            a = time.perf_counter()
            run.feed()
            torch.cuda.synchronize()
            box.update(ms=1e3 * (time.perf_counter() - a), syncs=SYNCS.count - s0,
                       updated=node.resample_count > r0,
                       resampled=node.resample_count > r0
                       and node.resample_count % node.config.resample_interval == 0)

        rose = {} if counts is None else counts.run(scan, 1)
        if counts is None:
            scan()
        out.append((box["ms"], box["syncs"], box["resampled"],
                    {k: v for k, v in rose.items() if v}, box["updated"]))
    return out


def scan_figures(rows, busy, label, smi):
    """The per-scan figures of `node_scans` rows and a device_busy reading,
    logged beside the card's nvidia-smi line."""
    walls = [r[0] for r in rows]
    syncs = [r[1] for r in rows]
    busy_ms, ops, top = busy
    wall_mean = statistics.mean(walls)
    out = dict(scan_ms_median=statistics.median(walls), scan_ms_mean=wall_mean,
               host_syncs_per_scan=statistics.mean(syncs),
               host_syncs_min_max=[min(syncs), max(syncs)],
               device_busy_ms_per_scan=busy_ms, device_ops_per_scan=ops,
               device_idle_share=1.0 - busy_ms / wall_mean, top_device_ops=top, device=smi)
    res = [r[0] for r in rows if r[2]]
    upd = [r[0] for r in rows if r[4] and not r[2]]
    if res and upd:
        out.update(scan_ms_median_resampling=statistics.median(res),
                   scan_ms_median_update_only=statistics.median(upd))
    log(f"{label} ({smi}): scan_received wall ms median {out['scan_ms_median']:.4f}, mean "
        f"{wall_mean:.4f}" + (f" (resampling scans {out['scan_ms_median_resampling']:.4f}, "
                              f"update-only {out['scan_ms_median_update_only']:.4f})"
                              if res and upd else "")
        + f" over {len(walls)} scans, CUDA synchronised; host syncs per scan "
        f"{out['host_syncs_per_scan']:.2f} ({min(syncs)}..{max(syncs)}); device busy ms per "
        f"scan {busy_ms:.4f}, device ops per scan {ops:.0f} (torch.profiler); idle share "
        f"{out['device_idle_share']:.3f} (of the mean wall ms)")
    log(f"{label} ({smi}): top device ops (ms/scan): "
        + "; ".join(f"{n} {t:.4f}" for n, t in top))
    return out


def phase_node(dev, smi):
    """The 2D node through its entry points (`make_node`, `map_msg_received`,
    `integrate_odom`, `scan_received`, `spin_once`, `global_localization`,
    `shutdown`) at 50,000 particles x 720 beams on the flagship map:
    tracking along a scripted path (per-scan wall ms, host syncs, device
    busy, launches per scan), global localization, pose persistence, the
    card node against a CPU node at 4096 x 360, the other models. Returns
    (the node path's launch counts, timings)."""
    import tempfile

    import numpy as np
    import torch

    from badger_amcl_tpu_torch import scenario
    from badger_amcl_tpu_torch.maps.occupancy_2d import OccupancyMap2D

    counts = Launches(counters_2d(), node_graphs().values())
    world = OccupancyMap2D.from_cells(scenario.map_cells(MAP_CELLS, 0), scenario.RESOLUTION,
                                      device=dev)
    t0 = time.perf_counter()
    run = NodeRun(dev, node_config(), world, NODE_SCANS)
    torch.cuda.synchronize()
    node = run.node
    ref = scenario.build_map(MAP_CELLS, device=dev)
    check(torch.equal(node.map.cells, ref.cells) and torch.equal(node.map.distances,
                                                                 ref.distances)
          and (node.map.origin_x, node.map.origin_y) == (ref.origin_x, ref.origin_y),
          "node: the map message does not rebuild scenario.build_map's cells, distances "
          "and origin")
    truth = torch.tensor(np.array(run.truth)[:, :2], dtype=torch.float32, device=dev)
    check(bool((world.cell_state_at(world.world_to_map(truth)) == -1).all()),
          "node: the scripted path leaves free space")
    log(f"node: map message -> {MAP_CELLS}^2 cells and distances equal to "
        f"scenario.build_map, origin ({node.map.origin_x}, {node.map.origin_y}); receipt "
        f"{run.map_s:.3f} s, {int(node.free_space_indices.shape[0])} free cells, backend "
        f"{node.backend}; {NODE_SCANS} scans raycast, set-up {time.perf_counter() - t0:.2f} s")

    box = {}

    def tracking():
        node_scans(run, NODE_WARMUP)
        box["rows"] = node_scans(run, NODE_SCANS - NODE_WARMUP - NODE_BUSY_SCANS)
        box["busy"] = device_busy(run.feed, steps=NODE_BUSY_SCANS)

    rose = counts.run(tracking, NODE_SCANS)
    check_node(run, "node tracking")
    # every scan updates but the one after the first: odometry init restarts
    # the integrator (node.cpp:1099-1112), so that scan sees no motion
    check(node.resample_count == NODE_SCANS - 1,
          f"node tracking: {node.resample_count} of {NODE_SCANS} scans updated")
    check(rose["corr_table"] > 0, "node tracking: corr_table (#1) was not launched")
    err_xy, err_yaw = run.pose_error()
    check(err_xy < 0.15 and err_yaw < 0.1,
          f"node tracking: amcl_pose {err_xy:.4f} m / {err_yaw:.4f} rad from the truth")
    timing = scan_figures(box["rows"], box["busy"], f"node tracking ({N_PARTICLES} x "
                          f"{N_BEAMS} on {MAP_CELLS}^2, {node.backend})", smi)
    per_scan = {k: v / NODE_SCANS for k, v in rose.items() if v}
    timing.update(launches_per_scan=per_scan, pose_error=[err_xy, err_yaw],
                  map_receipt_s=run.map_s)
    log(f"node tracking: launches per scan {per_scan}; amcl_pose {err_xy:.4f} m / "
        f"{err_yaw:.4f} rad from the truth; {len(run.out['amcl_pose'])} poses, "
        f"{len(run.out['tf'])} map->odom TFs published; n_active {int(node.state.n_active)}; "
        "host phases " + ", ".join(f"{k} {v['mean_ms']:.3f} ms x {v['count']}"
                                   for k, v in node.timers.report().items()))

    # pose persistence through the node, where PyYAML is installed
    try:
        import yaml  # noqa: F401
        timing["yaml"] = True
    except ImportError:
        timing["yaml"] = False
    if timing["yaml"]:
        from badger_amcl_tpu_torch.node import make_node

        with tempfile.TemporaryDirectory() as d:
            node.config = node.config.replace(
                save_pose=True, saved_pose_filepath=os.path.join(d, "saved_pose.yaml"))
            node.shutdown(run.scans[run.k - 1][0].stamp)
            again = make_node(node.config, device=dev)
            check(node.latest_pose is not None
                  and np.allclose(again.init_pose, node.latest_pose.pose, atol=1e-6),
                  "node: the saved pose did not load back")
        node.config = node.config.replace(save_pose=False)
        log(f"node: import yaml succeeded; pose {np.round(node.latest_pose.pose, 4).tolist()} "
            "saved at shutdown and loaded back by a new node")
    else:
        log("node: import yaml failed (no PyYAML on this machine): pose persistence not "
            "run, the nodes run with save_pose=False")

    # global localization: max_particles over the free cells, then a few scans
    node.global_localization()
    check(node.global_localization_active and int(node.state.n_active) == N_PARTICLES,
          "node: global localization did not scatter max_particles")
    run.extend(NODE_GL_SCANS)
    arms = []
    for _ in range(NODE_GL_SCANS):
        arms.append({k: v for k, v in counts.run(run.feed, 1).items() if v})
    check_node(run, "node global localization")
    timing["global_localization_launches"] = arms
    log(f"node global localization: launches per scan {arms}; n_active "
        f"{int(node.state.n_active)}, clusters {int(node.state.stats.cluster_count)}")

    timing["reference"] = phase_node_reference(dev, world)
    timing["models"] = phase_node_models(dev, world, counts, smi)
    return counts.read(), timing


def card_vs_cpu(runs, n_scans, label, on_scan=None, flips=None):
    """Feed every run (a "card" and a "cpu" one among them) `n_scans`
    scans; after each, the card node's weights against the CPU node's
    (`on_scan()` then runs); at the end the published particle clouds and
    amcl_poses within 1e-4 m.

    `flips(cpu_run)` marks the particles of the scan just fed with an
    endpoint a few f32 ulps from a cell boundary, where the card's and the
    CPU's rounding may take neighbouring cells; a mark lasts, since the
    weights carry over when nothing resamples. Every weight of an unmarked
    particle must agree to 1e-4 (relative, both sides normalised over the
    unmarked particles, so a flipped particle's share leaves the others
    alone), and >= 99.9% of all particles must agree to 1e-4 as they
    stand; without `flips` only the latter holds. Returns the worst
    scan's share, the disagreeing particles (count, worst relative
    difference, how many were marked) and the clouds' and poses' max
    differences."""
    import numpy as np
    import torch

    worst, marked, outliers, worst_rel = 1.0, None, set(), 0.0
    for k in range(n_scans):
        for r in runs.values():
            r.feed()
        w_c = runs["cpu"].node.state.weights
        w_g = runs["card"].node.state.weights.cpu()
        rel = (w_g - w_c).abs() / w_c.abs().clamp(min=1e-30)
        off = rel > 1e-4
        close = 1.0 - float(off.float().mean())
        worst = min(worst, close)
        if flips is not None:
            f = flips(runs["cpu"])
            marked = f if marked is None else marked | f
        keep = ~marked if marked is not None else torch.zeros_like(off)
        wk_c, wk_g = w_c * keep, w_g * keep
        rel_k = ((wk_g / wk_g.sum().clamp(min=1e-30) - wk_c / wk_c.sum().clamp(min=1e-30)).abs()
                 / (wk_c / wk_c.sum().clamp(min=1e-30)).abs().clamp(min=1e-30))
        bad = (rel_k > 1e-4) & keep
        for i in off.nonzero().flatten().tolist():
            if i not in outliers:
                log(f"{label} scan {k}: particle {i} weight {float(w_g[i]):.6e} on the card, "
                    f"{float(w_c[i]):.6e} on the CPU (rel {float(rel[i]):.3e}), "
                    f"{'marked' if marked is not None and bool(marked[i]) else 'UNMARKED'}")
            outliers.add(i)
            worst_rel = max(worst_rel, float(rel[i]))
        check(not bool(bad.any()), f"{label} scan {k}: {int(bad.sum())} unmarked particles' "
                                   f"weights differ by > 1e-4 (rel {float(rel_k.max()):.3e})")
        check(close >= 0.999, f"{label} scan {k}: only {close:.4f} of weights agree to 1e-4")
        if on_scan is not None:
            on_scan()
    n_marked = int(marked.sum()) if marked is not None else 0
    outs = {key: r.out for key, r in runs.items()}
    cloud = max(float(np.abs(a.poses - c.poses).max())
                for a, c in zip(outs["card"]["particlecloud"], outs["cpu"]["particlecloud"]))
    check(len(outs["card"]["particlecloud"]) == len(outs["cpu"]["particlecloud"]) > 0
          and cloud <= 1e-4, f"{label}: particle clouds differ by {cloud:.3g} m")
    pose = max(float(np.abs(a.pose - c.pose).max())
               for a, c in zip(outs["card"]["amcl_pose"], outs["cpu"]["amcl_pose"]))
    check(len(outs["card"]["amcl_pose"]) == len(outs["cpu"]["amcl_pose"]) > 0 and pose <= 1e-4,
          f"{label}: amcl_pose differs by {pose:.3g}")
    return dict(weights_within_1e4=worst, outliers=len(outliers),
                outliers_worst_rel=worst_rel, marked=n_marked, cloud_max_diff=cloud,
                pose_max_diff=pose)


def phase_node_reference(dev, world):
    """A card node against a CPU node (device="cpu"), both on "corr"
    (pallas_corr; the CPU runs the plain versions), the same converted
    state and message stream at 4096 x 360 on the flagship map: zero-noise
    odometry and no resample, so the pipeline is deterministic. Weights to
    1e-4 (>= 99.9% of particles), the published
    particle clouds and amcl_pose to 1e-4 m. A CPU node on "exact" is fed
    the same stream (logged: the lattice's distance from the exact
    endpoints)."""
    from badger_amcl_tpu_torch.ops import corr_kernel as ck

    n, b, n_scans = NODE_REF
    still = dict(min_particles=n, max_particles=n, laser_max_beams=b, resample_interval=1000,
                 odom_alpha1=0.0, odom_alpha2=0.0, odom_alpha3=0.0, odom_alpha4=0.0,
                 odom_alpha5=0.0)
    cfg = node_config(compute_backend="pallas_corr", **still)
    runs = {label: NodeRun(d, cfg.replace(compute_backend=be), world, n_scans, b,
                           init_cov=REGIMES["tracking"])
            for label, d, be in (("card", dev, "pallas_corr"), ("cpu", "cpu", "pallas_corr"),
                                 ("exact", "cpu", "xla"))}
    for label in ("card", "exact"):
        runs[label].node.state = to_device(runs["cpu"].node.state, runs[label].node.device)
    counts = Launches({"corr_table": ck.corr_table}, node_graphs().values())
    exact = {"rel": 0.0}

    def exact_rel():
        w_c, w_e = runs["cpu"].node.state.weights, runs["exact"].node.state.weights
        exact["rel"] = max(exact["rel"], float(((w_e - w_c).abs()
                                                / w_c.abs().clamp(min=1e-30)).max()))

    box = {}
    rose = counts.run(lambda: box.update(got=card_vs_cpu(runs, n_scans, "node reference",
                                                         exact_rel)), n_scans)
    got = box["got"]
    check(rose["corr_table"] > 0, "node reference: the card node launched no corr_table")
    log(f"node reference ({n} x {b} on {MAP_CELLS}^2, card vs CPU on corr, {n_scans} scans, "
        f"zero-noise odometry, no resample): weights within 1e-4: >= "
        f"{got['weights_within_1e4']:.4f} per scan ({got['outliers']} particles off); "
        f"particle clouds max diff {got['cloud_max_diff']:.3e} m, amcl_pose max diff "
        f"{got['pose_max_diff']:.3e}; corr_table launched {rose['corr_table']} "
        f"times on the card; CPU exact vs CPU corr weights max rel diff {exact['rel']:.3e} "
        f"(logged only)")
    return dict(got, exact_vs_corr_max_rel=exact["rel"])


def phase_node_models(dev, world, counts, smi):
    """A few scans of the flagship node with each other model and option,
    from the tracking regime's initial covariance (the cloud inside the
    lattice envelope): the beam model (the range image baked on map
    receipt), the prob model in log space with beam skipping, the int8
    corr backend, systematic resampling; each must keep finite weights and
    publish a pose."""
    out = {}
    for label, kw in NODE_MODELS.items():
        run = NodeRun(dev, node_config(**kw), world, NODE_MODEL_SCANS,
                      init_cov=REGIMES["tracking"])
        if label == "beam":
            check(run.node.map.range_image is not None,
                  "node beam: the range image was not baked on map receipt")
        t0 = time.perf_counter()
        rose = counts.run(lambda: [run.feed() for _ in range(NODE_MODEL_SCANS)],
                          NODE_MODEL_SCANS)
        sec = time.perf_counter() - t0
        check_node(run, f"node {label}")
        check(rose["lf_distances"] == 0, f"node {label}: the (B, M) lf_distances launched")
        err = run.pose_error()
        out[label] = dict(launches={k: v for k, v in rose.items() if v}, pose_error=list(err),
                          seconds=sec, map_receipt_s=run.map_s)
        log(f"node {label} ({N_PARTICLES} x {N_BEAMS}, {run.node.backend}; {smi}): "
            f"{NODE_MODEL_SCANS} scans in {sec:.3f} s (map receipt {run.map_s:.3f} s), "
            f"launches {out[label]['launches']}, {len(run.out['amcl_pose'])} poses, the last "
            f"{err[0]:.4f} m / {err[1]:.4f} rad from the truth")
    return out


# --- 3D node and the entry layer ---------------------------------------------

NODE3D_PARTICLES = 50_000
NODE3D_POINTS = 256
NODE3D_SCANS = 30
NODE3D_GL_SCANS = 4
NODE3D_PROD_SCANS = 6
NODE3D_REF = (4096, 128, 6)  # card vs CPU: particles, points, scans
NODE3D_RULE_SCANS = 6
CELL_FLIP_MARGIN = 1e-4  # cells; see CellFlips3D
# the scripted true path: 0.3 m per scan (above amcl_3d.yaml's 0.25 m
# gate, so every scan updates) and a 0.01 rad turn, in the part of the
# scene whose clouds the windowed arm's windows can reach (their origins
# are clamped 96 rows and 256 columns inside the texture and aligned down,
# so points within ~1.6 m of the north or east wall never fit)
NODE3D_START = (4.0, 5.0, 0.05)
NODE3D_STEP = (0.3, 0.01)
CLI_STEPS = 30


def node3d_config(tmp, **kw):
    """examples/amcl_3d.yaml through the port's `cli.load_config`, with kw
    replaced; the saved pose lives in `tmp` (none is loaded, none saved)."""
    from badger_amcl_tpu_torch import cli

    cfg = cli.load_config(os.path.join(ROOT, "examples", "amcl_3d.yaml"))
    return cfg.replace(save_pose=False,
                       saved_pose_filepath=os.path.join(tmp, "saved_pose.yaml"), **kw)


class Node3DRun(NodeRun):
    """A Node3D built through `make_node` on `dev`, fed the 3D scene as an
    OctomapMsg whose binary_data the port's write_bt wrote (the production
    branch: ROS octomap messages are binary), a TransformBuffer with
    odom->base and a static base->lidar, and the (Odometry, PointCloud2)
    stream of a scripted true path, each cloud `n_points` fresh voxel
    centres of the scene 0.5-6 m around the true pose, in the lidar frame
    (the scene's own cloud rule, `scenario.scene_3d`)."""

    start, step = NODE3D_START, NODE3D_STEP

    def __init__(self, dev, cfg, payload, occ, n_scans, n_points, init_cov=None, seed=0):
        from badger_amcl_tpu_torch import scenario
        from badger_amcl_tpu_torch.node.messages import OctomapMsg

        import numpy as np

        self.occ, self.n_points = np.asarray(occ, np.float64), n_points
        self.rng = np.random.default_rng(seed + 17)
        msg = OctomapMsg(resolution=scenario.RESOLUTION_3D, binary_data=payload)
        self._make(dev, cfg, "lidar", init_cov, seed, lambda node: node.octomap_msg_received(msg))
        self.extend(n_scans)

    def make_scan(self, pose, t):
        import numpy as np

        from badger_amcl_tpu_torch.node import Transform
        from badger_amcl_tpu_torch.node.messages import PointCloud2

        d = np.hypot(self.occ[:, 0] - pose[0], self.occ[:, 1] - pose[1])
        near = self.occ[(d > 0.5) & (d < 6.0)]
        sel = near[self.rng.choice(len(near), self.n_points, replace=False)]
        return PointCloud2(stamp=t, frame_id="lidar",
                           points=Transform.from_pose2d(pose).inverse().apply(sel))


def phase_node_3d(dev, smi):
    """The 3D node through its entry points (`make_node`,
    `octomap_msg_received`, `integrate_odom`, `scan_received`,
    `spin_once`, `global_localization`) with examples/amcl_3d.yaml loaded
    by the port's `cli.load_config`: the map set-up stage by stage;
    tracking at 50,000 particles x 256 points (per-scan wall ms, host
    syncs, device busy, launches per scan; the pose within 0.3 m and 0.25
    rad); global localization; the card node against a CPU node at 4096 x
    128; the production config unchanged. Returns (the node_3d path's
    launch counts, timings)."""
    import tempfile

    import numpy as np
    import torch

    from badger_amcl_tpu_torch import scenario
    from badger_amcl_tpu_torch.maps.octomap_3d import OctoMap3D
    from badger_amcl_tpu_torch.maps.octree_io import read_bt, write_bt
    from badger_amcl_tpu_torch.ops import edt_kernel as ek

    counts = Launches({**counters_3d(), "edt_3d": ek.voxel_texture_3d}, node_graphs().values())
    occ, _ = scenario.scene_3d()
    with tempfile.TemporaryDirectory() as tmp:
        # the map set-up, stage by stage (the node's receipt runs all three)
        t0 = time.perf_counter()
        write_bt(os.path.join(tmp, "scene.bt"), scenario.RESOLUTION_3D, occ)
        write_s = time.perf_counter() - t0
        with open(os.path.join(tmp, "scene.bt"), "rb") as f:
            payload = f.read()
        cfg = node3d_config(tmp, min_particles=NODE3D_PARTICLES,
                            max_particles=NODE3D_PARTICLES, laser_max_beams=NODE3D_POINTS)
        t0 = time.perf_counter()
        tree = read_bt(payload)
        read_s = time.perf_counter() - t0
        md = cfg.resolved_cloud_likelihood_max_dist
        staged, edt_s = timed(lambda: OctoMap3D.from_binary_octree(
            tree, md, device=dev).with_distance_field())
        vol = staged.occupancy_volume()
        plain = ek.voxel_texture_3d_plain(vol, staged.resolution, md)
        t0 = time.perf_counter()
        want = numpy_texture(vol.cpu().numpy(), staged.resolution, md)
        numpy_s = time.perf_counter() - t0
        check(torch.equal(staged.tex_zyx, plain)
              and np.array_equal(staged.tex_zyx.cpu().numpy(), want),
              "node_3d: the scene's card EDT differs from its plain version or the numpy EDT")
        edt_ms = cuda_ms(lambda: ek.voxel_texture_3d(vol, staged.resolution, md))
        edt_plain_ms = cuda_ms(lambda: ek.voxel_texture_3d_plain(vol, staged.resolution, md))
        scipy_s = scipy_seconds(vol.cpu().numpy() == 0)
        world = tree.occupied_centers()  # the clouds sample the map's own voxels
        # from the steady covariance, the cloud's per-point windows fit (#9's
        # fused sums) while the Gompertz model lets it widen over the scans
        box = {}
        rose = counts.run(lambda: box.setdefault("run", Node3DRun(
            dev, cfg, payload, world, NODE3D_SCANS, NODE3D_POINTS,
            init_cov=REGIMES["steady"])), 1)
        run = box.pop("run")
        node = run.node
        check(rose["edt_3d"] == 1, f"node_3d: the receipt launched edt_3d {rose['edt_3d']} times")
        check(torch.equal(node.map.tex_zyx, plain) and node.map.min_cells == staged.min_cells,
              "node_3d: the octomap message's receipt does not give the plain version's "
              "texture")
        check(node.backend == "corr", f"node_3d: backend {node.backend}, not corr")
        setup = dict(scene_voxels=len(occ), octree_keys=len(tree.occupied_keys),
                     payload_bytes=len(payload), texture=list(node.map.size),
                     write_bt_s=write_s, read_bt_s=read_s, edt_s=edt_s, edt_kernel_ms=edt_ms,
                     edt_plain_ms=edt_plain_ms, numpy_edt_s=numpy_s, scipy_edt_s=scipy_s,
                     node_receipt_s=run.map_s)
        log(f"node_3d set-up: scene {len(occ)} voxel centres -> {len(tree.occupied_keys)} "
            f"octree keys, .bt {len(payload)} bytes written in {write_s:.4f} s; read_bt "
            f"{read_s:.4f} s, card EDT {edt_s:.4f} s ({node.map.size} voxels: centres, "
            f"scatter, kernel; the kernel {edt_ms:.4f} ms, its plain version "
            f"{edt_plain_ms:.4f} ms; bit-equal to both and to the numpy EDT, "
            f"{numpy_s:.4f} s on the host; scipy "
            f"{'not run' if scipy_s is None else f'{scipy_s:.4f} s'}); the node's receipt "
            f"{run.map_s:.4f} s (read, card EDT)")
        del vol, plain, want

        box = {}
        warm = node_scans(run, NODE_WARMUP, counts)
        rows = node_scans(run, NODE3D_SCANS - NODE_WARMUP - NODE_BUSY_SCANS, counts)
        rose = collections.Counter(counts.run(
            lambda: box.setdefault("busy", device_busy(run.feed, steps=NODE_BUSY_SCANS)),
            NODE_BUSY_SCANS))
        for r in warm + rows:
            rose.update(r[3])
        err_xy, err_yaw = run.pose_error()
        errors = [round(math.hypot(p.pose[0] - run.truth[int(round(p.stamp / 0.1))][0],
                                   p.pose[1] - run.truth[int(round(p.stamp / 0.1))][1]), 4)
                  for p in run.out["amcl_pose"]]
        timing = dict(setup=setup, tracking=scan_figures(
            rows, box["busy"], f"node_3d tracking ({NODE3D_PARTICLES} x "
            f"{NODE3D_POINTS}, {node.backend})", smi))
        per_scan = {k: v / NODE3D_SCANS for k, v in rose.items() if v}
        timing["tracking"].update(launches_per_scan=per_scan, pose_error=[err_xy, err_yaw],
                                  launches_by_scan=[r[3] for r in warm + rows],
                                  pose_errors_m=errors)
        log(f"node_3d tracking: launches per scan {per_scan}; by scan "
            f"{timing['tracking']['launches_by_scan']}; amcl_pose {err_xy:.4f} m / "
            f"{err_yaw:.4f} rad from the truth (each published pose, m: {errors}); "
            f"{len(run.out['amcl_pose'])} poses; n_active "
            f"{int(node.state.n_active)}; host phases "
            + ", ".join(f"{k} {v['mean_ms']:.3f} ms x {v['count']}"
                        for k, v in node.timers.report().items()))
        check_node(run, "node_3d tracking")
        check(node.resample_count == NODE3D_SCANS - 1,
              f"node_3d tracking: {node.resample_count} of {NODE3D_SCANS} scans updated")
        for k in ("pc_extents", "pc_term_sums"):
            check(rose[k] > 0, f"node_3d tracking: {k} (#9) was not launched")
        check(rose["pc_distances"] == 0, "node_3d tracking: the (B, M) pc_distances launched")
        check(err_xy < 0.3 and err_yaw < 0.25,
              f"node_3d tracking: amcl_pose {err_xy:.4f} m / {err_yaw:.4f} rad from the truth")

        t0 = time.perf_counter()
        node.global_localization()
        torch.cuda.synchronize()
        gl_s = time.perf_counter() - t0
        check(node.global_localization_active and int(node.state.n_active) == NODE3D_PARTICLES,
              "node_3d: global localization did not scatter max_particles")
        run.extend(NODE3D_GL_SCANS + NODE_BUSY_SCANS)
        rows = node_scans(run, NODE3D_GL_SCANS, counts)
        busy = device_busy(run.feed, steps=NODE_BUSY_SCANS)
        check_node(run, "node_3d global localization")
        arms = [r[3] for r in rows]
        check(any(a.get("pc_spread_term_sums") for a in arms),
              "node_3d global localization: pc_spread_term_sums (#10) was not launched")
        timing["global_localization"] = scan_figures(
            rows, busy, "node_3d global localization", smi)
        timing["global_localization"].update(launches=arms, call_s=gl_s)
        log(f"node_3d global localization: the call {gl_s:.4f} s; launches per scan {arms}; "
            f"n_active {int(node.state.n_active)}, clusters "
            f"{int(node.state.stats.cluster_count)}")
        del run, node
        timing["reference"] = phase_node_3d_reference(dev, payload, world, tmp)
        timing["production"] = phase_node_3d_production(dev, payload, world, tmp, counts, smi)
        timing["scene_rule"] = phase_node_3d_scene_rule(dev, payload, occ, tmp, counts, smi)
    return counts.read(), timing


class CellFlips3D:
    """The particles of a Node3D's last scan with a cloud endpoint within
    `margin` cells of a cell boundary in x or y: the endpoint
    (x + cos(t) qx - sin(t) qy) / res + 1/2 in f64 from the node's f32
    poses and points, as every 3D arm floors it. A few f32 ulps of the
    ~400-cell coordinates (3.05e-5 cells each), the card's and the CPU's
    cos/sin and their poses' last-ulp differences (the published clouds
    agree to 1e-6 m, 2e-5 cells at 0.05 m) stay under 1e-4 cells. `closest` keeps each particle's nearest approach over
    the scans."""

    def __init__(self, margin):
        self.margin, self.closest = margin, None

    def __call__(self, run):
        import numpy as np
        import torch

        from badger_amcl_tpu_torch.ops.pc_kernel import _inv_res

        node = run.node
        poses = node.state.poses.double().numpy()
        q = node.latest_points_base.double().numpy()
        inv_res = _inv_res(node.map)
        c, s = np.cos(poses[:, 2]), np.sin(poses[:, 2])
        near = np.full(len(poses), np.inf)
        for x, qa, qb, sign in ((poses[:, 0], q[:, 0], q[:, 1], -1.0),
                                (poses[:, 1], q[:, 1], q[:, 0], 1.0)):
            # x: x + c qx - s qy; y: y + c qy + s qx
            u = (x[None, :] + c[None, :] * qa[:, None]
                 + sign * s[None, :] * qb[:, None]) * inv_res + 0.5
            near = np.minimum(near, np.abs(u - np.round(u)).min(axis=0))
        self.closest = near if self.closest is None else np.minimum(self.closest, near)
        return torch.from_numpy(near < self.margin)


def phase_node_3d_reference(dev, payload, occ, tmp):
    """A card Node3D against a CPU Node3D (device="cpu"), both on "corr"
    (pallas_corr; the CPU runs the plain versions), the same converted
    state and message stream at 4096 particles x 128 points: zero-noise
    odometry and no resample. Every weight to 1e-4 but those of particles
    with an endpoint within CELL_FLIP_MARGIN cells of a cell boundary
    (`CellFlips3D`), and >= 99.9% of all; the published particle clouds
    and amcl_pose to 1e-4 m."""
    import numpy as np

    from badger_amcl_tpu_torch.ops import pc_kernel as pk

    n, b, n_scans = NODE3D_REF
    cfg = node3d_config(tmp, min_particles=n, max_particles=n, laser_max_beams=b,
                        resample_interval=1000, odom_alpha1=0.0, odom_alpha2=0.0,
                        odom_alpha3=0.0, odom_alpha4=0.0, odom_alpha5=0.0,
                        compute_backend="pallas_corr")
    runs = {label: Node3DRun(d, cfg, payload, occ, n_scans, b, init_cov=REGIMES["tracking"])
            for label, d in (("card", dev), ("cpu", "cpu"))}
    runs["card"].node.state = to_device(runs["cpu"].node.state, dev)
    counts = Launches({"pc_extents": pk.pc_extents}, node_graphs().values())
    flips = CellFlips3D(CELL_FLIP_MARGIN)
    box = {}
    rose = counts.run(lambda: box.update(got=card_vs_cpu(runs, n_scans, "node_3d reference",
                                                         flips=flips)), n_scans)
    got = box["got"]
    check(rose["pc_extents"] > 0, "node_3d reference: the card node launched no pc_extents")
    w_c = runs["cpu"].node.state.weights
    w_g = runs["card"].node.state.weights.cpu()
    off = ((w_g - w_c).abs() > 1e-4 * w_c.abs()).nonzero().flatten().tolist()
    got.update(outlier_closest_cells=[float(flips.closest[i]) for i in off],
               margin_cells=CELL_FLIP_MARGIN,
               marked_share=got["marked"] / n,
               closest_quantiles=[float(x) for x in np.quantile(flips.closest, [0.001, 0.01])])
    log(f"node_3d reference ({n} x {b}, card vs CPU on corr, {n_scans} scans, zero-noise "
        f"odometry, no resample): weights within 1e-4: >= {got['weights_within_1e4']:.4f} "
        f"per scan; {got['outliers']} particles off (worst rel {got['outliers_worst_rel']:.3e}),"
        f" nearest approach to a cell boundary of those off at the end "
        f"{got['outlier_closest_cells']} cells; {got['marked']} of {n} particles came within "
        f"{CELL_FLIP_MARGIN} cells (0.1% / 1% quantiles of every particle's nearest approach "
        f"{got['closest_quantiles']}); particle clouds max diff {got['cloud_max_diff']:.3e} m,"
        f" amcl_pose max diff {got['pose_max_diff']:.3e}; pc_extents launched "
        f"{rose['pc_extents']} times on the card")
    return got


def phase_node_3d_scene_rule(dev, payload, occ, tmp, counts, smi):
    """The tracking node fed clouds by the scene's own rule: voxel centres
    of `scenario.scene_3d`'s scene, not of the map the .bt round trip
    rebuilt, which sits half a voxel up (the writer keys floor(c / res),
    the map cells floor(c / res + 1/2)). Reported: the arms each scan
    took, the pose error; checked: a sane state."""
    cfg = node3d_config(tmp, min_particles=NODE3D_PARTICLES, max_particles=NODE3D_PARTICLES,
                        laser_max_beams=NODE3D_POINTS)
    run = Node3DRun(dev, cfg, payload, occ, NODE3D_RULE_SCANS, NODE3D_POINTS,
                    init_cov=REGIMES["steady"])
    rows = node_scans(run, NODE3D_RULE_SCANS, counts)
    check_node(run, "node_3d scene rule")
    arms = [r[3] for r in rows]
    err = run.pose_error()
    log(f"node_3d scene rule ({NODE3D_PARTICLES} x {NODE3D_POINTS}, clouds of the scene's "
        f"own voxel centres; {smi}): launches per scan {arms}; the pose {err[0]:.4f} m / "
        f"{err[1]:.4f} rad from the truth; scan ms {[round(r[0], 2) for r in rows]}")
    return dict(launches=arms, pose_error=list(err), scan_ms=[r[0] for r in rows], device=smi)


def phase_node_3d_production(dev, payload, occ, tmp, counts, smi):
    """examples/amcl_3d.yaml unchanged (KLD between 1,000 and 10,000
    particles, 128 points, systematic resampling every 2nd update, the
    uniform pool's score rejection) for a few scans from the tracking
    covariance: finite weights, a published pose, the particle count after
    each resample."""
    cfg = node3d_config(tmp)
    run = Node3DRun(dev, cfg, payload, occ, NODE3D_PROD_SCANS, cfg.resolved_cloud_max_beams,
                    init_cov=REGIMES["tracking"], seed=1)
    node, n_active = run.node, []
    t0 = time.perf_counter()
    rows = []
    for _ in range(NODE3D_PROD_SCANS):
        rows += node_scans(run, 1, counts)
        if rows[-1][2]:
            n_active.append(int(node.state.n_active))
    sec = time.perf_counter() - t0
    check_node(run, "node_3d production")
    check(n_active and all(cfg.min_particles <= n <= cfg.max_particles for n in n_active),
          f"node_3d production: particle counts {n_active} after the resamples")
    err = run.pose_error()
    out = dict(particles_after_resample=n_active, scan_ms=[r[0] for r in rows],
               host_syncs=[r[1] for r in rows], launches=[r[3] for r in rows],
               pose_error=list(err), seconds=sec, map_receipt_s=run.map_s, device=smi)
    log(f"node_3d production (examples/amcl_3d.yaml: {cfg.min_particles}-{cfg.max_particles} "
        f"particles, {cfg.resolved_cloud_max_beams} points, {node.backend}; {smi}): "
        f"{NODE3D_PROD_SCANS} scans in {sec:.3f} s (map receipt {run.map_s:.3f} s), particles "
        f"after each resample {n_active}, scan ms {[round(r[0], 2) for r in rows]}, host syncs "
        f"{out['host_syncs']}, launches {out['launches']}; the last pose {err[0]:.4f} m / "
        f"{err[1]:.4f} rad from the truth")
    return out


# --- the nodes' compiled helpers ------------------------------------------------

NODE_C_SCANS = 30
NODE_C_GL_SCANS = 4
NODE_C_BUSY_SCANS = 4
NODE_C_CLI_SCANS = 30
NODE_C_3D_SCANS = 24
NODE_C_MODEL_SCANS = 20
# the flagship node with each model or backend the compiled step took in
# last: {label: (config keys, initial covariance, scans after global
# localization)}. The beam node tracks with precise odometry from the steady
# covariance: its lattice window spans 64 yaw bins of 1/160 rad, and at the
# default alphas (0.2) one motion update spreads the cloud's yaw past that,
# so every scan took the spread arm (#8)
NODE_C_BEAM_ALPHAS = {f"odom_alpha{i}": 0.005 for i in range(1, 5)}
NODE_C_MODELS = {
    "corr_q": (dict(compute_backend="pallas_corr_q"), "tracking", 0),
    "prob_log": (dict(laser_model_type="likelihood_field_prob",
                      laser_likelihood_log_space=True), "tracking", NODE_C_GL_SCANS),
    "prob_log_beamskip": (dict(laser_model_type="likelihood_field_prob",
                               laser_likelihood_log_space=True, do_beamskip=True),
                          "tracking", 0),
    "beam": (dict(laser_model_type="beam", **NODE_C_BEAM_ALPHAS), "steady", NODE_C_GL_SCANS),
}
POSE_TOL = 1e-4  # m / rad: compiled vs eager published poses (as STATS_TOL)
# the helpers the strict wrappers stand in for, {module name: helper names}
NODE_HELPERS = {"node": ("_motion_update_jit", "_resample_jit", "_uniform_pool_jit"),
                "node_2d": ("_sensor_update_jit", "_score_poses_jit"),
                "node_3d": ("_sensor_update_jit", "_score_poses_jit")}


@dataclasses.dataclass
class StrictHelpers:
    """The node modules' graph_jit helpers, each called under sync debug
    mode "error" (graph_jit turns it off for a capture, so only a replay
    is held to it) and counted by name; an eager node calls the functions
    they wrap (`__wrapped__`) past them."""

    calls: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    saved: dict = dataclasses.field(default_factory=dict)

    def __enter__(self):
        import importlib

        import torch

        for mod_name, names in NODE_HELPERS.items():
            mod = importlib.import_module(f"badger_amcl_tpu_torch.node.{mod_name}")
            for name in names:
                jit = getattr(mod, name)
                self.saved[mod, name] = jit

                def call(*args, _jit=jit, _key=f"{mod_name}.{name}", **kwargs):
                    self.calls[_key] += 1
                    torch.cuda.set_sync_debug_mode("error")
                    try:
                        return _jit(*args, **kwargs)
                    finally:
                        torch.cuda.set_sync_debug_mode("default")

                call.__wrapped__ = jit.__wrapped__
                setattr(mod, name, call)
        return self

    def __exit__(self, *exc):
        for (mod, name), jit in self.saved.items():
            setattr(mod, name, jit)


class CliRun(NodeRun):
    """The CLI's simulator stream (`cli.run_sim`: the room grid, SIM_START,
    SIM_TWIST, the simulator's seeded odometry noise and ranges), made
    ahead of the scans (the simulator's TF history serves every stamp) and
    fed to a node that `make_node` built from `cfg`."""

    def __init__(self, dev, cfg, n_scans, seed=0):
        import numpy as np

        from badger_amcl_tpu_torch import cli
        from badger_amcl_tpu_torch.node import make_node
        from badger_amcl_tpu_torch.sim import Sim2D, make_room_grid

        grid = make_room_grid()
        self.sim = Sim2D(grid, start_pose=cli.SIM_START, base_frame=cfg.base_frame_id)
        self.node = make_node(cfg, tf_buffer=self.sim.tf, seed=seed, device=dev)
        self.node.init_pose = np.array(cli.SIM_START)
        self.out = {k: [] for k in ("amcl_pose", "particlecloud", "tf")}
        for k, v in self.out.items():
            self.node.subscribe_output(k, v.append)
        self.node.map_msg_received(grid)
        self.scans, self.truth_at, self.k = [], {}, 0
        self.extend(n_scans)

    def extend(self, n):
        from badger_amcl_tpu_torch import cli

        for _ in range(n):
            odom = self.sim.step(*cli.SIM_TWIST)
            self.truth_at[round(self.sim.t, 6)] = self.sim.true_pose.copy()
            self.scans.append((odom, self.sim.make_scan()))

    def feed(self):
        odom, scan = self.scans[self.k]
        self.k += 1
        self.node.integrate_odom(odom)
        self.node.scan_received(scan)
        self.node.spin_once(odom.stamp)

    def pose_error(self):
        p = self.out["amcl_pose"][-1]
        true = self.truth_at[round(p.stamp, 6)]
        return (math.hypot(p.pose[0] - true[0], p.pose[1] - true[1]),
                abs(math.remainder(p.pose[2] - true[2], 2 * math.pi)))


def compare_twins(twins, label, k):
    """The compiled node against its eager twin after scan k: n_active and
    the particle poses equal, every published amcl_pose within POSE_TOL.
    Returns the weights' and the published poses' largest differences."""
    import numpy as np
    import torch

    c, e = twins["compiled"], twins["eager"]
    cs, es = c.node.state, e.node.state
    check(torch.equal(cs.n_active, es.n_active),
          f"{label} scan {k}: n_active {int(cs.n_active)} vs {int(es.n_active)} eager")
    check(torch.equal(cs.poses, es.poses), f"{label} scan {k}: the particle poses differ from "
                                           f"the eager twin's")
    pc, pe = c.out["amcl_pose"], e.out["amcl_pose"]
    check(len(pc) == len(pe), f"{label} scan {k}: {len(pc)} poses published vs {len(pe)}")
    pose = max((float(np.abs(a.pose - b.pose).max()) for a, b in zip(pc, pe)), default=0.0)
    check(pose <= POSE_TOL, f"{label} scan {k}: published poses differ by {pose:.3e}")
    return float((cs.weights - es.weights).abs().max()), pose


def graph_arm_totals(graphs):
    """{arm: executions} summed over every entry of the graph wrappers."""
    out = collections.Counter()
    for g in graphs.values():
        out.update(graph_arms(g))
    return out


def drive_twins(twins, n, label, counts, strict, graphs):
    """n scans fed to the compiled node and its eager twin in turns, each
    compared after the scan: (rows {mode: node_scans rows}, score rounds
    per compiled scan, whether the compiled scan captured a graph, worst
    weight and pose differences, the compiled node's device arms and the
    eager twin's arms over the run)."""
    from badger_amcl_tpu_torch.utils import control

    rows, rounds, captured = {"compiled": [], "eager": []}, [], []
    worst_w = worst_p = 0.0
    arms0, eager0 = graph_arm_totals(graphs), collections.Counter(control.ARMS)
    for k in range(n):
        calls0 = strict.calls["node_2d._score_poses_jit"] + strict.calls["node_3d._score_poses_jit"]
        captures0 = sum(g.captures for g in graphs.values())
        rows["compiled"] += node_scans(twins["compiled"], 1, counts)
        captured.append(sum(g.captures for g in graphs.values()) > captures0)
        rounds.append(strict.calls["node_2d._score_poses_jit"]
                      + strict.calls["node_3d._score_poses_jit"] - calls0)
        rows["eager"] += node_scans(twins["eager"], 1)
        w, p = compare_twins(twins, label, k)
        worst_w, worst_p = max(worst_w, w), max(worst_p, p)
    arms = +(graph_arm_totals(graphs) - arms0)
    eager_arms = +(collections.Counter(control.ARMS) - eager0)
    return rows, rounds, captured, worst_w, worst_p, arms, eager_arms


def twin_figures(twins, rows, rounds, captured, label, smi):
    """scan_figures of each twin over the scans in which no graph was
    captured (device busy over NODE_C_BUSY_SCANS more scans each, compared
    after), the nodes' host phases, score rounds and ms per round."""
    out = {}
    for mode, run in twins.items():
        run.extend(NODE_C_BUSY_SCANS)
        busy = device_busy(run.feed, steps=NODE_C_BUSY_SCANS)
        kept = [r for r, c in zip(rows[mode], captured) if not c]
        out[mode] = scan_figures(kept, busy, f"{label} {mode}", smi)
        out[mode].update(capture_scans=sum(captured), host_phases=run.node.timers.report())
        log(f"{label} {mode}: {sum(captured)} scans that captured a graph left out; host "
            "phases " + ", ".join(f"{k} {v['mean_ms']:.3f} ms x {v['count']}"
                                  for k, v in run.node.timers.report().items()))
    compare_twins(twins, label + " (after the busy window)", "busy")
    res = [r for r, row, c in zip(rounds, rows["compiled"], captured) if row[2] and not c]
    if res:
        per = statistics.median(res)
        for mode, fig in out.items():
            if "scan_ms_median_resampling" in fig and per:
                fig["ms_per_score_round"] = ((fig["scan_ms_median_resampling"]
                                              - fig["scan_ms_median_update_only"]) / per)
        log(f"{label}: score rounds per resampling scan {res} (median {per}); ms per round "
            "(resampling minus update-only median, over the rounds) "
            + ", ".join(f"{m} {f.get('ms_per_score_round', float('nan')):.4f}"
                        for m, f in out.items()))
        out["score_rounds_per_resampling_scan"] = res
    return out


def second_receipt(run, receive, graphs, label):
    """The map received again by the compiled node: no live entry may hold
    the old map or free cells; the live entries and the memory the
    allocator keeps before and after, logged. Returns the figures."""
    import torch

    old_map, old_fsi = run.node.map, run.node.free_space_indices
    live0 = sum(len(g.entries) for g in graphs.values())
    torch.cuda.synchronize()
    reserved0 = torch.cuda.memory_reserved()
    receive(run.node)
    del old_fsi
    held = sum(1 for g in graphs.values() for e in g.entries.values()
               for v in e.references.values() if v is old_map)
    check(held == 0, f"{label}: {held} graph entries still hold the old map")
    del old_map
    torch.cuda.empty_cache()
    live = sum(len(g.entries) for g in graphs.values())
    out = dict(live_entries_before=live0, live_entries_after=live,
               reserved_gb_before=reserved0 / 1e9,
               reserved_gb_after=torch.cuda.memory_reserved() / 1e9)
    log(f"{label}: a second map receipt left {live} live graph_jit entries (of {live0}), none "
        f"holding the old map; allocator reserved {out['reserved_gb_before']:.3f} GB -> "
        f"{out['reserved_gb_after']:.3f} GB after empty_cache")
    return out


def drop_node(run):
    """Release a node's graph entries (its map and free cells)."""
    node = run.node
    if node.free_space_indices is not None:
        node.release_graphs(node.free_space_indices)
    node.map = None


def run_twins(make, n, label, counts, strict, graphs, smi, gl_scans=0, receive=None):
    """A compiled node and its eager twin (`make(mode)` -> a NodeRun; the
    twin's `compiled` set False), driven n scans, then gl_scans after
    global localization on both; figures, arms (the compiled node's device
    counters equal the eager twin's arms), pose errors, keys and captures
    per helper, then a second map receipt (`receive`)."""
    twins = {mode: make(mode) for mode in ("compiled", "eager")}
    check(twins["compiled"].node.compiled, f"{label}: the node is not compiled")
    twins["eager"].node.compiled = False
    captures0 = {k: g.captures for k, g in graphs.items()}
    # held, so that no entry of this run takes the id of one released in it
    entries0 = {id(e): e for g in graphs.values() for e in g.entries.values()}
    t0 = time.perf_counter()
    rows, rounds, captured, w, p, arms, eager_arms = drive_twins(twins, n, label, counts,
                                                                 strict, graphs)
    errors = {m: list(r.pose_error()) for m, r in twins.items()}
    gl = {}
    if gl_scans:
        for run in twins.values():
            run.node.global_localization()
            run.extend(gl_scans)
        g_rows, _, _, gw, gp, g_arms, g_eager = drive_twins(twins, gl_scans, label + " gl",
                                                             counts, strict, graphs)
        w, p = max(w, gw), max(p, gp)
        arms.update(g_arms)
        eager_arms.update(g_eager)
        gl = dict(launches=[r[3] for r in g_rows["compiled"]],
                  scan_ms={m: [r[0] for r in rs] for m, rs in g_rows.items()})
    check(arms == eager_arms, f"{label}: compiled arms {dict(arms)} != eager {dict(eager_arms)}")
    figs = twin_figures(twins, rows, rounds, captured, label, smi)
    keys = {k: len(g.entries) for k, g in graphs.items()}
    captures = {k: g.captures - captures0[k] for k, g in graphs.items()}
    # the IF nodes (one handle kernel each, graph_cond.cu) of each graph this run captured
    if_nodes = {k: [len(e.capture.slots) for e in g.entries.values() if id(e) not in entries0]
                for k, g in graphs.items()}
    for k, graph_ifs in if_nodes.items():  # no key is ever captured twice
        check(captures[k] == len(graph_ifs), f"{label}: {k} captured {captures[k]} graphs "
                                             f"for {len(graph_ifs)} new keys")
    out = dict(figs, arms=dict(arms), weights_max_diff=w, pose_max_diff=p, pose_error=errors,
               live_keys=keys, captures=captures, if_nodes_per_graph=if_nodes, gl=gl,
               launches_by_scan=[r[3] for r in rows["compiled"]],
               seconds=time.perf_counter() - t0)
    log(f"{label}: {n} scans{f' + {gl_scans} after global localization' if gl_scans else ''}, "
        f"the compiled node equal to its eager twin at every scan (n_active, particle poses; "
        f"weights max diff {w:.3e}, published poses max diff {p:.3e}); arms (device counters "
        f"= the eager twin's) {dict(arms)}; pose error m/rad after the {n} scans {errors}; "
        f"live keys {keys}, captures this run {captures} (one a new key), IF nodes per new "
        f"graph {if_nodes}; launches by scan {out['launches_by_scan']}")
    if receive is not None:
        out["second_receipt"] = second_receipt(twins["compiled"], receive, graphs, label)
    for run in twins.values():
        drop_node(run)
    return out


def phase_node_compiled(dev, smi):
    """The nodes' compiled helpers on the card, each node beside an eager
    twin (same config, seed and stream; its helpers run uncaptured): the
    flagship 2D node at 50,000 x 720 (30 tracking scans, 4 after global
    localization), the same node with each model the compiled step took in
    last (NODE_C_MODELS: corr_q, the prob model in log space with and
    without beam skipping, the beam model with its range image baked;
    NODE_C_MODEL_SCANS tracking scans, then global localization where
    given), examples/amcl_2d.yaml unchanged on the CLI's map and stream
    (8,000 x 60, score rejection) and examples/amcl_3d.yaml at 50,000 x
    256 on the scene. Checks at every scan n_active and the particle poses
    equal and the published poses within POSE_TOL, the arms equal, no host
    read inside a replay (sync debug mode "error"), the old map's entries
    gone after a second receipt, and #1, #3, #4 (its sums, extents and
    counts), #6, #7, #8, #9, #10 and cluster_labels launched inside
    replays. Returns (the path's launch counts, timings)."""
    import tempfile

    from badger_amcl_tpu_torch import cli, scenario
    from badger_amcl_tpu_torch.maps.occupancy_2d import OccupancyMap2D
    from badger_amcl_tpu_torch.maps.octree_io import read_bt, write_bt
    from badger_amcl_tpu_torch.node.messages import OctomapMsg
    from badger_amcl_tpu_torch.sim import make_room_grid

    graphs = node_graphs()
    counts = Launches({**counters_2d(), **counters_3d()}, graphs.values())
    out = {}
    t_phase = time.perf_counter()
    with StrictHelpers() as strict:
        world = OccupancyMap2D.from_cells(scenario.map_cells(MAP_CELLS, 0),
                                          scenario.RESOLUTION, device=dev)
        out["flagship_2d"] = run_twins(
            lambda mode: NodeRun(dev, node_config(), world, NODE_C_SCANS), NODE_C_SCANS,
            f"node_compiled 2d ({N_PARTICLES} x {N_BEAMS})", counts, strict, graphs, smi,
            gl_scans=NODE_C_GL_SCANS,
            receive=lambda node: node.map_msg_received(scenario.grid_msg(MAP_CELLS)))
        for label, (kw, regime, gl) in NODE_C_MODELS.items():
            out[label] = run_twins(
                lambda mode, kw=kw, regime=regime: NodeRun(
                    dev, node_config(**kw), world, NODE_C_MODEL_SCANS, init_cov=REGIMES[regime]),
                NODE_C_MODEL_SCANS, f"node_compiled {label} ({N_PARTICLES} x {N_BEAMS})",
                counts, strict, graphs, smi, gl_scans=gl)
        del world
        cfg = cli.load_config(os.path.join(ROOT, "examples", "amcl_2d.yaml")).replace(
            save_pose=False)
        out["amcl_2d_yaml"] = run_twins(
            lambda mode: CliRun(dev, cfg, NODE_C_CLI_SCANS), NODE_C_CLI_SCANS,
            f"node_compiled amcl_2d.yaml ({cfg.min_particles}-{cfg.max_particles} x "
            f"{cfg.laser_max_beams}, CLI stream)", counts, strict, graphs, smi,
            receive=lambda node: node.map_msg_received(make_room_grid()))
        occ, _ = scenario.scene_3d()
        with tempfile.TemporaryDirectory() as tmp:
            write_bt(os.path.join(tmp, "scene.bt"), scenario.RESOLUTION_3D, occ)
            with open(os.path.join(tmp, "scene.bt"), "rb") as f:
                payload = f.read()
            cfg3 = node3d_config(tmp, min_particles=NODE3D_PARTICLES,
                                 max_particles=NODE3D_PARTICLES, laser_max_beams=NODE3D_POINTS)
            centres = read_bt(payload).occupied_centers()
            msg = OctomapMsg(resolution=scenario.RESOLUTION_3D, binary_data=payload)
            out["amcl_3d_yaml"] = run_twins(
                lambda mode: Node3DRun(dev, cfg3, payload, centres, NODE_C_3D_SCANS,
                                       NODE3D_POINTS, init_cov=REGIMES["tracking"]),
                NODE_C_3D_SCANS, f"node_compiled amcl_3d.yaml ({NODE3D_PARTICLES} x "
                f"{NODE3D_POINTS})", counts, strict, graphs, smi,
                receive=lambda node: node.octomap_msg_received(msg))
    replayed = dict(counts.replayed)
    for k in ("corr_table", "spread_term_sums", "lf_term_sums", "lf_extents", "pc_extents",
              "pc_term_sums", "pc_spread_term_sums", "cluster_labels", "corr_table_q",
              "lf_obs_counts", "beam_table", "beam_spread_sums"):
        check(replayed.get(k, 0) > 0, f"node_compiled: {k} never launched inside a replay")
    out.update(replayed_launches=replayed, helper_calls=dict(strict.calls),
               phase_s=time.perf_counter() - t_phase)
    log(f"node_compiled: kernel launches inside replays {replayed}; helper calls "
        f"{dict(strict.calls)}; the phase took {out['phase_s']:.1f} s")
    return counts.read(), out


# --- the capped statistics ------------------------------------------------------

CAPPED_CLUSTERS = 128  # PFParams.stats_max_clusters, the fleet scenario's
CAPPED_REGIMES = ("tracking", "spread")
CAPPED_NODE_SCANS = 20


def phase_capped(dev, smi):
    """The capped statistics (PFParams.stats_max_clusters = CAPPED_CLUSTERS:
    the capped multinomial arm, the statistics ranked afresh through the
    "cluster.sorted" cond) compiled, at 50,000 x 720 on the flagship map:
    `sensor_resample_step_jit` from the tracking and the spread cloud and
    `mcl_step_2d_jit` from the tracking one, COMPILED_CHAIN chained
    replays each against the eager step on the same variates
    (compiled_chain); then a capped 2D node (the flagship config, its
    PFParams capped) beside an eager twin for CAPPED_NODE_SCANS tracking
    scans (run_twins: equal at every scan, the arms equal, no host read
    inside a replay). Returns (the path's launch counts, timings)."""
    import torch

    from badger_amcl_tpu_torch import mcl, scenario
    from badger_amcl_tpu_torch.maps.occupancy_2d import OccupancyMap2D
    from badger_amcl_tpu_torch.node import node as tnode
    from badger_amcl_tpu_torch.sensors.planar import PlanarScanParams

    sp = PlanarScanParams()
    omap = scenario.build_map(MAP_CELLS, device=dev)
    scan = scenario.build_scan(N_BEAMS, device=dev)
    odom = [torch.tensor(v, dtype=torch.float32, device=dev) for v in ODOM[:3]]
    graphs = {"sensor_resample_step": mcl.sensor_resample_step_jit.graph,
              "mcl_step_2d": mcl.mcl_step_2d_jit.graph}
    for g in graphs.values():
        g.kernels.update(counters_2d())
    counts = Launches(counters_2d(), graphs.values())
    out = {}
    for regime, path in [(r, "sensor_resample_step") for r in CAPPED_REGIMES] + [
            ("tracking", "mcl_step_2d")]:
        tag = f"capped {regime}/{path} ({N_PARTICLES} x {N_BEAMS}, {CAPPED_CLUSTERS} clusters)"
        params, state, pool = scenario.build_filter(N_PARTICLES, pose_cov=REGIMES[regime],
                                                    min_particles=N_PARTICLES, device=dev)
        params = dataclasses.replace(params, stats_max_clusters=CAPPED_CLUSTERS)
        motion = path == "mcl_step_2d"
        if motion:
            fns = {f.__name__: (lambda s, nz, f=f: f(s, omap, sp, scan, pool, *odom, ODOM[3],
                                                     params, backend="corr", noise=nz))
                   for f in (mcl.mcl_step_2d, mcl.mcl_step_2d_jit)}
        else:
            fns = {f.__name__: (lambda s, nz, f=f: f(s, omap, sp, scan, pool, params,
                                                     backend="corr", noise=nz))
                   for f in (mcl.sensor_resample_step, mcl.sensor_resample_step_jit)}
        eager_fn, jit_fn = fns[path], fns[path + "_jit"]
        gen = torch.Generator(device=dev).manual_seed(17)
        noises = [mcl.StepNoise.draw(gen, N_PARTICLES, dev, odom=motion)
                  for _ in range(COMPILED_CHAIN)]
        first = first_call(graphs[path], lambda: jit_fn(state, noises[0]))
        diff, arms, _, compiled, rose = compiled_chain(tag, state, noises, eager_fn, jit_fn,
                                                       graphs[path], counts)
        check(arms["cluster.sorted:true"] + arms["cluster.sorted:false"] == COMPILED_CHAIN
              and not arms["resample.u_count:true"] + arms["resample.u_count:false"],
              f"{tag}: not the capped arms: {dict(arms)}")
        check_state(compiled[-1], params, tag)
        check(int(compiled[-1].stats.cluster_count) >= 1
              and not bool(compiled[-1].stats.cluster_valid[CAPPED_CLUSTERS:].any()),
              f"{tag}: statistics past the cap")
        figs = step_figures(tag, state, N_PARTICLES, {"compiled": jit_fn, "eager": eager_fn},
                            lambda: mcl.StepNoise.draw(gen, N_PARTICLES, dev, odom=motion), smi)
        out[f"{regime}/{path}"] = dict(figs, arms=dict(arms), chain_stats_diff=diff,
                                       clusters=int(compiled[-1].stats.cluster_count), **first)
        log(f"{tag}: {COMPILED_CHAIN} chained replays equal to the eager step (float "
            f"statistics max diff {diff}); arms {dict(arms)}; clusters after the chain "
            f"{int(compiled[-1].stats.cluster_count)}; first call {first}")
    del omap, scan

    # a capped node: no configuration key sets the cap, so the node's
    # PFParams are capped where it builds them
    node_graph = node_graphs()
    for g in node_graph.values():
        g.kernels.update(counters_2d())
    node_counts = Launches(counters_2d(), node_graph.values())
    pf_params = tnode.Node.__dict__["_pf_params"]

    def capped(mode):
        tnode.Node._pf_params = staticmethod(lambda cfg: dataclasses.replace(
            pf_params.__func__(cfg), stats_max_clusters=CAPPED_CLUSTERS))
        try:
            run = NodeRun(dev, node_config(), world, CAPPED_NODE_SCANS,
                          init_cov=REGIMES["tracking"])
        finally:
            tnode.Node._pf_params = pf_params
        check(run.node.params.stats_max_clusters == CAPPED_CLUSTERS, "capped node: no cap")
        return run

    with StrictHelpers() as strict:
        world = OccupancyMap2D.from_cells(scenario.map_cells(MAP_CELLS, 0),
                                          scenario.RESOLUTION, device=dev)
        out["node_2d"] = run_twins(capped, CAPPED_NODE_SCANS,
                                   f"capped node 2d ({N_PARTICLES} x {N_BEAMS}, "
                                   f"{CAPPED_CLUSTERS} clusters)", node_counts, strict,
                                   node_graph, smi)
        del world
    check(node_counts.replayed["corr_table"] > 0, "capped node: #1 never launched in a replay")
    paths = counts.read()
    for k, (n, steps) in node_counts.read().items():
        paths[k] = (paths[k][0] + n, paths[k][1] + steps)
    return paths, out


# --- the compiled entries, bounded ---------------------------------------------

ENTRY_SCANS = 40
ENTRY_SIZES = (200, 5000)  # raw cloud points, drawn per scan
ENTRY_SEED = 23
ENTRY_ALPHAS = (0.15, 0.25, 0.35)  # odom_alpha1..5 of each reconfiguration
# scans after each reconfiguration: the first initialises the odometry, the
# second its integrator, the third runs the motion model (its new key)
ENTRY_SCANS_AFTER = 3
RESERVED_TOL = 0.05  # memory_reserved after the drop, relative to before the node


class SizedCloudRun(Node3DRun):
    """A Node3DRun whose clouds have the raw sizes `sizes` in turn (capped
    at the scene's voxel centres 0.5-6 m around the pose)."""

    def __init__(self, dev, cfg, payload, occ, n_scans, sizes, init_cov=None):
        self.sizes = iter(sizes)
        super().__init__(dev, cfg, payload, occ, n_scans, 0, init_cov=init_cov)

    def make_scan(self, pose, t):
        import numpy as np

        d = np.hypot(self.occ[:, 0] - pose[0], self.occ[:, 1] - pose[1])
        self.n_points = min(int(next(self.sizes)), int(((d > 0.5) & (d < 6.0)).sum()))
        return super().make_scan(pose, t)


def entry_figures(graphs):
    """({helper: live entries}, {helper: captures so far}, torch's reserved
    bytes) after a synchronise."""
    import torch

    torch.cuda.synchronize()
    return ({k: len(g.entries) for k, g in graphs.items()},
            {k: g.captures for k, g in graphs.items()}, torch.cuda.memory_reserved())


def phase_entries_bound(dev, smi):
    """The compiled 3D node (examples/amcl_3d.yaml, 50,000 particles) fed
    ENTRY_SCANS clouds whose raw sizes are drawn from ENTRY_SIZES (seeded):
    every decimated size is a new key of the sensor update and the pose
    score. Per scan the live entries per helper, the captures, their
    seconds and torch.cuda.memory_reserved(); then three reconfigurations
    with new alphas, each followed by ENTRY_SCANS_AFTER scans; then the
    node dropped. Checks live entries at or under utils.graph.MAX_ENTRIES
    at every scan, no entry keyed on a replaced configuration's alphas or
    PFParams that no live node holds, no entry holding the dropped node's
    map, which is freed, and memory_reserved after the drop and
    empty_cache within RESERVED_TOL of its value before the node was
    built. Returns the figures."""
    import gc
    import tempfile
    import weakref

    import numpy as np
    import torch

    from badger_amcl_tpu_torch import scenario
    from badger_amcl_tpu_torch.maps.octree_io import read_bt, write_bt
    from badger_amcl_tpu_torch.node import node as node_mod
    from badger_amcl_tpu_torch.utils import graph as graph_mod

    bound = graph_mod.MAX_ENTRIES
    graphs = node_graphs()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    live0, _, reserved0 = entry_figures(graphs)
    n_after = len(ENTRY_ALPHAS) * ENTRY_SCANS_AFTER
    sizes = np.random.default_rng(ENTRY_SEED).integers(ENTRY_SIZES[0], ENTRY_SIZES[1] + 1,
                                                       ENTRY_SCANS + n_after)
    occ, _ = scenario.scene_3d()
    rows = []
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        write_bt(os.path.join(tmp, "scene.bt"), scenario.RESOLUTION_3D, occ)
        with open(os.path.join(tmp, "scene.bt"), "rb") as f:
            payload = f.read()
        cfg = node3d_config(tmp, min_particles=NODE3D_PARTICLES, max_particles=NODE3D_PARTICLES)
        run = SizedCloudRun(dev, cfg, payload, read_bt(payload).occupied_centers(), ENTRY_SCANS,
                            sizes, init_cov=REGIMES["tracking"])
        check(run.node.compiled, "entries: the 3D node is not compiled")

        def scan(label):
            ids0 = {id(e): e for g in graphs.values() for e in g.entries.values()}
            live_b, caps0, _ = entry_figures(graphs)
            t0 = time.perf_counter()
            run.feed()
            live, caps, reserved = entry_figures(graphs)
            new = [round(e.capture_s, 4) for g in graphs.values() for e in g.entries.values()
                   if id(e) not in ids0]
            row = dict(scan=label, raw_points=int(run.scans[run.k - 1][1].points.shape[0]),
                       points=int(run.node.latest_points_base.shape[0]),
                       wall_s=time.perf_counter() - t0, live=live,
                       captures=sum(caps.values()) - sum(caps0.values()), capture_s=new,
                       reserved_gb=reserved / 1e9)
            rows.append(row)
            log(f"entries scan {label}: {row['raw_points']} -> {row['points']} points, "
                f"{row['wall_s']:.3f} s; live {live}; captures {row['captures']} "
                f"({new} s); reserved {row['reserved_gb']:.3f} GB")
            over = {k: n for k, n in live.items() if n > bound}
            check(not over, f"entries scan {label}: {over} live entries over the bound {bound}")
            return row

        for k in range(ENTRY_SCANS):
            scan(k)
        motion, resample = node_mod._motion_update_jit, node_mod._resample_jit
        reconf = []
        for i, alpha in enumerate(ENTRY_ALPHAS):
            old_cfg, old_params = run.node.config, run.node.params
            old_alphas = tuple(float(getattr(old_cfg, f"odom_alpha{j}")) for j in range(1, 6))
            run.node.reconfigure(old_cfg.replace(**{f"odom_alpha{j}": alpha
                                                    for j in range(1, 6)}))
            # the replaced values' entries, where no other live node holds them
            others = {name: node_mod._HOLDERS[name, v]
                      for name, v in (("alphas", old_alphas), ("params", old_params))}
            stale = (sum(1 for key in motion.entries if dict(key[0])["alphas"] == old_alphas
                         and not others["alphas"])
                     + sum(1 for key in resample.entries if dict(key[0])["params"] == old_params
                           and not others["params"]))
            run.extend(ENTRY_SCANS_AFTER)
            for k in range(ENTRY_SCANS_AFTER):
                scan(f"r{i}.{k}")
            reconf.append(dict(alphas=alpha, stale_entries=stale, other_holders=others,
                               motion_entries=len(motion.entries)))
            log(f"entries reconfigure {i} (alphas {alpha}): {stale} entries keyed on the "
                f"replaced alphas / PFParams left (other live nodes holding them {others}); "
                f"motion model entries {len(motion.entries)}")
            check(stale == 0, f"entries reconfigure {i}: {stale} entries keyed on the "
                              f"replaced configuration")
        held = weakref.ref(run.node.map)
        live_before_drop, _, reserved_before_drop = entry_figures(graphs)
        del run
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        live_after, caps_after, reserved_after = entry_figures(graphs)
        holding = sum(1 for g in graphs.values() for e in g.entries.values()
                      for v in e.references.values() if v is held())
    drift = (reserved_after - reserved0) / max(reserved0, 1)
    captured = [r for r in rows if r["captures"]]
    per_entry = [r["reserved_gb"] - p["reserved_gb"] for p, r in zip(rows, rows[1:])
                 if r["captures"]]
    out = dict(bound=bound, scans=rows, reconfigure=reconf, live_before=live0,
               reserved_gb_before=reserved0 / 1e9, live_before_drop=live_before_drop,
               reserved_gb_before_drop=reserved_before_drop / 1e9, live_after_drop=live_after,
               reserved_gb_after_drop=reserved_after / 1e9, reserved_drift=drift,
               map_freed=held() is None, entries_holding_map=holding,
               capture_scans=len(captured), captures=sum(r["captures"] for r in rows),
               capture_s=[x for r in rows for x in r["capture_s"]],
               reserved_gb_per_capture_scan=per_entry,
               wall_s_capture_scans=[r["wall_s"] for r in captured],
               wall_s_other_scans=[r["wall_s"] for r in rows if not r["captures"]],
               phase_s=time.perf_counter() - t_phase, device=smi)
    log(f"entries ({smi}): bound {bound}; {out['captures']} captures over {len(rows)} scans "
        f"({len(captured)} scans captured), capture s median "
        f"{statistics.median(out['capture_s']) if out['capture_s'] else 0:.4f}; scan wall s "
        f"median with a capture {statistics.median(out['wall_s_capture_scans'] or [0]):.4f}, "
        f"without {statistics.median(out['wall_s_other_scans'] or [0]):.4f}; reserved GB "
        f"before the node {reserved0 / 1e9:.3f}, before the drop "
        f"{reserved_before_drop / 1e9:.3f}, after the drop and empty_cache "
        f"{reserved_after / 1e9:.3f} ({drift:+.4f}); live entries before {live0}, before the "
        f"drop {live_before_drop}, after {live_after}; the map freed {held() is None}, "
        f"{holding} entries holding it; the phase took {out['phase_s']:.1f} s")
    check(held() is None and holding == 0, "entries: the dropped node's map is still held")
    check(abs(drift) <= RESERVED_TOL,
          f"entries: memory_reserved {reserved_after / 1e9:.3f} GB after the drop, "
          f"{drift:+.4f} of the {reserved0 / 1e9:.3f} GB before the node")
    return out


# --- the compiled grid arms inside replays ----------------------------------------

GRID_ARMS = ("resample.u_count:false", "cluster.stats_width:false")
GRID_SEED = 21


def map_spread_state(omap, params, seed):
    """An MCLState of max_samples poses on free cells of the map drawn
    uniformly (a global localization's cloud) with uniform yaw, from a
    seeded numpy generator."""
    import numpy as np
    import torch

    from badger_amcl_tpu_torch.pf import filter as pf_filter

    fsi = omap.free_space_indices()
    rng = np.random.default_rng(seed)
    ij = fsi[rng.integers(0, len(fsi), params.max_samples)]
    xy = ((ij - np.array([omap.size_x // 2, omap.size_y // 2])) * omap.resolution
          + np.array([omap.origin_x, omap.origin_y]))
    yaw = rng.uniform(-math.pi, math.pi, params.max_samples)
    poses = np.concatenate([xy, yaw[:, None]], axis=1).astype(np.float32)
    return pf_filter.init_with_poses(params, torch.as_tensor(poses, device=omap.device))


def unique_bins(poses, params):
    """The KLD bins a set of poses occupies (the resampler's u_count)."""
    import torch

    from badger_amcl_tpu_torch.pf import kld

    ones = torch.ones((poses.shape[0],), dtype=torch.bool, device=poses.device)
    _, flat = kld.grid_cells(kld.bin_keys(poses), ones, params.hist_shape)
    return int(kld.sort_by_bin(flat, ones)[3].sum())


def phase_grid_arms(dev, omap, scan, pool):
    """The compiled step's grid arms inside replays: the KLD stop's prefix
    scan past MAX_UNIQUE_BINS occupied bins (resample.u_count:false) and
    the wide statistics past MAX_FAST_CLUSTERS clusters
    (cluster.stats_width:false). sensor_resample_step_jit (likelihood_field
    on "corr": the spread arm) on 50,000 poses spread uniformly over the
    1024^2 map's free cells: COMPILED_CHAIN chained replays against the
    eager step on the same variates (compare_chain), the device arm
    counters over those replays against the eager arms, 0 host syncs; both
    arms must be taken in the replays. Returns the figures."""
    import torch

    from badger_amcl_tpu_torch import mcl
    from badger_amcl_tpu_torch.pf import cluster
    from badger_amcl_tpu_torch.pf.types import PFParams
    from badger_amcl_tpu_torch.sensors.planar import PlanarScanParams

    sp = PlanarScanParams()
    params = PFParams(min_samples=N_PARTICLES, max_samples=N_PARTICLES)
    state = map_spread_state(omap, params, GRID_SEED)
    graph = mcl.sensor_resample_step_jit.graph
    out = {"unique_bins": unique_bins(state.poses, params),
           "max_unique_bins": cluster.MAX_UNIQUE_BINS,
           "max_fast_clusters": cluster.MAX_FAST_CLUSTERS}

    def case(label, omap_k):
        gen = torch.Generator(device=dev).manual_seed(GRID_SEED)
        noises = [mcl.StepNoise.draw(gen, N_PARTICLES, dev, odom=False)
                  for _ in range(COMPILED_CHAIN)]
        captures0 = graph.captures

        def step(s, nz, f):
            return f(s, omap_k, sp, scan, pool, params, backend="corr", noise=nz)

        def eager_fn(s, nz):
            return step(s, nz, mcl.sensor_resample_step)

        def jit_fn(s, nz):
            return step(s, nz, mcl.sensor_resample_step_jit)

        jit_fn(state, noises[0])
        stats, arms, eager, compiled, _ = compiled_chain(label, state, noises, eager_fn,
                                                         jit_fn, graph)
        again, s = [], state
        for nz in noises:
            s = eager_fn(s, nz)
            again.append(s)
        twice = compare_chain(label + " (eager twice)", eager, again)
        clusters = [int(c.stats.cluster_count) for c in compiled]
        bins = [unique_bins(c.poses[:int(c.n_active)], params) for c in compiled]
        row = dict(arms=dict(arms), chain_stats_diff=stats, eager_twice_stats_diff=twice,
                   captures=graph.captures - captures0, unique_bins_by_step=bins,
                   clusters_by_step=clusters)
        log(f"{label}: {COMPILED_CHAIN} chained replays equal to the eager step (float "
            f"statistics max diff {stats}; the eager step against itself {twice}); arms in "
            f"the replays (device counters = the eager arms) {dict(arms)}; unique bins after "
            f"each step {bins}, clusters {clusters}; captures {row['captures']}")
        return row

    out["spread"] = case(f"grid_arms spread ({N_PARTICLES} over {MAP_CELLS}^2, "
                         f"{out['unique_bins']} unique bins of {cluster.MAX_UNIQUE_BINS})", omap)
    taken = {a: out["spread"]["arms"].get(a, 0) for a in GRID_ARMS}
    for a in GRID_ARMS:
        check(taken[a] > 0, f"grid_arms: {a} never taken inside a replay of the spread cloud")
    out["taken_in_replays"] = dict(taken)
    log(f"grid_arms: the grid arms taken inside replays {dict(taken)}")
    return out


def cli_truth(steps):
    """[(stamp, true pose)] of the CLI simulator's scripted path
    (`cli.SIM_START`, `cli.SIM_TWIST`), its odometry noise aside."""
    from badger_amcl_tpu_torch import cli
    from badger_amcl_tpu_torch.sim import Sim2D, make_room_grid

    sim = Sim2D(make_room_grid(), start_pose=cli.SIM_START)
    out = []
    for _ in range(steps):
        sim.step(*cli.SIM_TWIST)
        out.append((sim.t, sim.true_pose.copy()))
    return out


def cli_kernels(node):
    """#4 against its plain versions on the CLI node's own inputs: its last
    scan (60 beams) on its 480^2 map, at its particle cloud (the update's
    shape, the scanner's params) and at a fresh uniform pool of
    max_samples poses (the pool's score rejection, the base params):
    the (B, M) distances >= 99.99% equal (max error within a cell's
    diagonal, plus a bf16 step), the window extents equal on every beam
    whose endpoint cells agree, fits equal, and the fused term sums within
    1e-5 (relative) on every particle whose endpoint cells agree (those
    with a flip are logged)."""
    import torch

    from badger_amcl_tpu_torch.ops import lf_kernel as lk
    from badger_amcl_tpu_torch.sensors import planar

    omap, scan = node.map, node.latest_scan
    model = node.config.laser_model_type.value
    valid = scan.valid()
    out = {}
    for label, params, poses in (
            ("cloud", node.scanner_params[0], node.state.poses),
            ("pool", node._base_params, node._draw_pool(node.params.max_samples))):
        spose = planar.coord_add(params.scanner_pose, poses)
        rest = (spose, scan.ranges, scan.angles)
        tex = lk.lf_texture(omap, *rest)
        dtype = str(tex.dtype).split(".")[-1]
        got, want = lk.lf_distances(omap, tex, *rest), lk.lf_distances_plain(omap, tex, *rest)
        ext, ext_p = lk.beam_extents(omap, *rest), lk.beam_extents_plain(omap, *rest)
        term = planar.model_term(model, params, scan.range_max)
        sums = lk.lf_term_sums(omap, tex, *rest, valid, term)
        sums_p = lk.lf_term_sums_plain(omap, tex, *rest, valid, term)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        eq = float((diff == 0).float().mean())
        tol = omap.resolution * math.sqrt(2.0) + (2.0 ** -7 if dtype == "bfloat16" else 0.0)
        check(eq >= 0.9999 and float(diff.max()) <= tol,
              f"cli #4 ({label}): lf_distances {eq:.6f} equal, max err {float(diff.max())}")
        flip_beams = (diff > 0).any(dim=1)
        flipped = (diff > 0).any(dim=0)
        fits, fits_p = lk.window_finish(omap, ext)[2], lk.window_finish(omap, ext_p)[2]
        odd = (ext != ext_p).any(dim=0)
        check(bool(fits) == bool(fits_p) and not bool((odd & ~flip_beams).any()),
              f"cli #4 ({label}): extents differ on beams "
              f"{(odd & ~flip_beams).nonzero().flatten().tolist()}, fits {bool(fits)} vs "
              f"{bool(fits_p)}")
        rel = (sums - sums_p).abs() / sums_p.abs().clamp(min=1e-30)
        rel_kept = float(rel[~flipped].max())
        check(rel_kept <= 1e-5, f"cli #4 ({label}): lf_term_sums rel err {rel_kept} > 1e-5")
        rel_flip = float(rel[flipped].max()) if bool(flipped.any()) else 0.0
        out[label] = dict(particles=int(spose.shape[0]), beams=int(scan.ranges.shape[0]),
                          texture=dtype, distances_equal=eq, fits=bool(fits),
                          extents_beams_off=int(odd.sum()), flipped_particles=int(flipped.sum()),
                          sums_max_rel=rel_kept, flipped_sums_max_rel=rel_flip)
        log(f"cli #4 ({label}: {spose.shape[0]} x {scan.ranges.shape[0]} on "
            f"{omap.size_x}^2, {dtype}): lf_distances {eq:.6f} equal; extents off on "
            f"{int(odd.sum())} beams (each with a cell flip), fits {bool(fits)}; "
            f"lf_term_sums max rel {rel_kept:.3e} ({int(flipped.sum())} particles with a "
            f"cell flip: max rel {rel_flip:.3e})")
    return out


def phase_cli(dev, smi):
    """The entry point as a user starts it: the port's `cli.run` (what
    `cli.main` returns the code of) with examples/amcl_2d.yaml and the
    built-in simulator for 30 steps, on the card (the default device), in
    a temporary working directory: rc 0, the node's state on CUDA, the pose
    saved on exit, the last published pose within 0.3 m and 0.25 rad of
    the simulator's truth; then #4, which the path launches (the room is a
    240^2 grid; the config supersamples it 2x to 480^2 at 0.025 m), against
    its plain versions on the node's own inputs (`cli_kernels`). Returns
    (the cli path's launch counts, timing)."""
    import tempfile

    from badger_amcl_tpu_torch import cli

    counts = Launches(counters_2d(), node_graphs().values())
    box = {}
    argv = ["--config", os.path.join(ROOT, "examples", "amcl_2d.yaml"), "--sim", "--steps",
            str(CLI_STEPS), "--seed", "0"]
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            t0 = time.perf_counter()
            rose = counts.run(lambda: box.setdefault("out", cli.run(argv)), CLI_STEPS)
            wall = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
        saved = os.path.exists(os.path.join(tmp, "badger_amcl_saved_pose.yaml"))
    rc, node = box["out"]
    check(rc == 0, f"cli: main returned {rc}")
    check(node.state.poses.device.type == "cuda", f"cli: the node's state is on "
                                                  f"{node.state.poses.device}")
    check(saved, "cli: no pose was saved on exit")
    check(node.last_published_pose is not None, "cli: no amcl_pose was published")
    p = node.last_published_pose
    t_true, true = min(cli_truth(CLI_STEPS), key=lambda tp: abs(tp[0] - p.stamp))
    err = (math.hypot(p.pose[0] - true[0], p.pose[1] - true[1]),
           abs(math.remainder(p.pose[2] - true[2], 2 * math.pi)))
    check(abs(t_true - p.stamp) < 1e-6 and err[0] < 0.3 and err[1] < 0.25,
          f"cli: amcl_pose {err[0]:.4f} m / {err[1]:.4f} rad from the truth at {p.stamp}")
    launched = {k: v for k, v in rose.items() if v}
    log(f"cli ({smi}): python -m badger_amcl_tpu_torch {' '.join(argv[:2])} "
        f"{' '.join(argv[2:])}: rc 0 in {wall:.3f} s wall; node {type(node).__name__} on "
        f"{node.device}, backend {node.backend}, map {node.map.size_x}^2 at "
        f"{node.map.resolution} m, {node.resample_count} updates; kernel launches "
        f"{launched or 0}; the last amcl_pose {p.pose.tolist()} at {p.stamp:.1f} s, "
        f"{err[0]:.4f} m / {err[1]:.4f} rad from the truth; the pose saved on exit")
    kern = cli_kernels(node)
    return counts.read(), dict(seconds=wall, launches=launched, updates=node.resample_count,
                               map_cells=[node.map.size_x, node.map.size_y],
                               backend=node.backend, pose_error=list(err), kernels=kern,
                               device=smi)


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

    t_start = time.perf_counter()
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

    # 2D paths: the likelihood field, the beam model, Gompertz and prob
    from badger_amcl_tpu_torch.sensors import planar

    t0 = time.perf_counter()
    omap = scenario.build_map(MAP_CELLS, device=dev)
    scan = scenario.build_scan(N_BEAMS, device=dev)
    built = {}
    for c in CELLS_2D.values():
        if (c.particles, c.cov) not in built:
            built[c.particles, c.cov] = scenario.build_filter(
                c.particles, pose_cov=c.cov, min_particles=c.particles, device=dev)
    states = {key: built[c.particles, c.cov] for key, c in CELLS_2D.items()}
    torch.cuda.synchronize()
    log(f"scenario: {N_PARTICLES} x {N_BEAMS} on {MAP_CELLS}^2 in "
        f"{time.perf_counter() - t0:.2f} s")
    kernels = phase_kernels(dev, omap, scan, states)
    cluster_rows = phase_kernels_cluster(cluster_grids(states))
    kernels.update(phase_kernels_q(omap, scan, states))
    bmap, bake_s, bake_bytes = phase_range_image(dev, omap)
    maps = {"likelihood_field": omap, "beam": bmap,
            **{m: planar.bake_corr_texture(omap, planar.PlanarScanParams(), 8.0, m)
               for m in LF_MODELS}}
    for key, c in CELLS_2D.items():
        if c.model == "beam":
            spose = planar.coord_add(planar.PlanarScanParams().scanner_pose,
                                     states[key][1].poses)
            arm = planar.beam_arm(bmap, scan, spose)
            log(f"{key}: the beam dispatch takes the {arm} arm")
            check(arm == {"beam_table": "table", "beam_spread_sums": "spread"}[c.kernel],
                  f"{key} takes the {arm} arm")
    kernels.update(phase_kernels_beam(dev, bmap, scan, states))
    paths = phase_main_path(dev, maps, scan, states)
    phase_reference(dev)
    timings = phase_timings(dev, maps, scan, states)
    paths["2d_compiled"], timings["compiled"] = phase_compiled(dev, maps, scan, states, smi)
    timings["grid_arms"] = phase_grid_arms(dev, maps["likelihood_field"], scan,
                                           cell_state("spread", states)[2])
    timings["graph_cond"] = phase_graph_cond(dev)
    timings["range_image_bake"] = dict(seconds=bake_s, bytes=bake_bytes)
    paths["2d_cells"], timings["cells"] = phase_cells(dev, maps, scan, states)
    paths["2d_cells_compiled"], timings["cells_compiled"] = phase_cells_compiled(
        dev, maps, scan, states, smi)
    phase_cells_reference(dev)
    del bmap, maps, scan, states, built
    torch.cuda.empty_cache()

    # fleet path on the likelihood-field map
    t0 = time.perf_counter()
    fl = scenario.build_fleet(FLEET_ROBOTS, FLEET_PARTICLES, FLEET_BEAMS, device=dev)
    torch.cuda.synchronize()
    log(f"scenario fleet: {FLEET_ROBOTS} robots x {FLEET_PARTICLES} x {FLEET_BEAMS} on "
        f"{MAP_CELLS}^2, fleet_init in {time.perf_counter() - t0:.2f} s")
    kernels.update(phase_kernels_fleet(dev, omap, fl))
    cluster_rows.update(phase_kernels_cluster(fleet_cluster_grids(dev, omap, fl)))
    # the kernels line's row is the full grid, the spread cells' every step;
    # its error the largest over every grid
    kernels["cluster_labels"] = dict(
        cluster_rows["full (spread)"],
        max_abs_err=max(r["max_abs_err"] for r in cluster_rows.values()))
    paths["fleet"] = phase_main_path_fleet(dev, omap, fl)
    phase_reference_fleet(dev, omap)
    timings["fleet"] = phase_timings_fleet(dev, omap, fl)
    # the compiled fleet step's captures attribute these kernels' launches to their arms
    from badger_amcl_tpu_torch import fleet

    fleet_graph = fleet.make_fleet_step(fl[0]).graph
    fleet_graph.kernels.update(fleet_counters())
    paths["fleet_compiled"], timings["fleet_compiled"] = phase_fleet_compiled(dev, omap, fl,
                                                                              smi)
    paths["sharded_fleet"], timings["sharded_fleet"] = phase_sharded_fleet(dev, omap, fl)
    fleet_graph.release(omap)
    del omap, fl
    torch.cuda.empty_cache()

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
    paths["3d"] = phase_main_path_3d(dev, omap3, cloud, states3)
    phase_reference_3d(dev, omap3)
    timings.update(phase_timings_3d(dev, omap3, cloud, states3))
    del omap3, cloud, states3
    torch.cuda.empty_cache()

    # the nodes' graph_jit helpers attribute these kernels' launches to their arms
    for jit in node_graphs().values():
        jit.kernels.update(counters_2d(), **counters_3d())

    # the maps' distance fields at the receipt of store-sized maps
    paths["map_setup"], edt_kernels, timings["map_setup"] = phase_map_setup(dev, smi)
    kernels.update(edt_kernels)

    # the 2D node, the 3D node, the command line
    paths["node_2d"], timings["node_2d"] = phase_node(dev, smi)
    paths["node_3d"], timings["node_3d"] = phase_node_3d(dev, smi)
    paths["cli"], timings["cli"] = phase_cli(dev, smi)
    paths["node_compiled"], timings["node_compiled"] = phase_node_compiled(dev, smi)
    paths["capped"], timings["capped"] = phase_capped(dev, smi)
    timings["entries"] = phase_entries_bound(dev, smi)
    launches = launch_counts(paths)

    meta = {
        "corr_table": ("badger_amcl_tpu_torch/csrc/corr_table.cu",
                       "badger_amcl_tpu/ops/corr_kernel.py:227"),
        "spread_term_sums": ("badger_amcl_tpu_torch/csrc/spread_term_sums.cu",
                             "badger_amcl_tpu/ops/spread_kernel.py:556"),
        "lf_distances": ("badger_amcl_tpu_torch/csrc/lf_distances.cu",
                         "badger_amcl_tpu/ops/lf_kernel.py:182"),
        "lf_term_sums": ("badger_amcl_tpu_torch/csrc/lf_distances.cu",
                         "badger_amcl_tpu/ops/lf_kernel.py:182"),
        "lf_obs_counts": ("badger_amcl_tpu_torch/csrc/lf_distances.cu",
                          "badger_amcl_tpu/ops/lf_kernel.py:182"),
        "lf_extents": ("badger_amcl_tpu_torch/csrc/lf_distances.cu",
                       "badger_amcl_tpu/ops/lf_kernel.py:182"),
        "pc_term_sums": ("badger_amcl_tpu_torch/csrc/pc_distances.cu",
                         "badger_amcl_tpu/ops/pc_kernel.py:168"),
        "pc_extents": ("badger_amcl_tpu_torch/csrc/pc_distances.cu",
                       "badger_amcl_tpu/ops/pc_kernel.py:168"),
        "pc_distances": ("badger_amcl_tpu_torch/csrc/pc_distances.cu",
                         "badger_amcl_tpu/ops/pc_kernel.py:168"),
        "pc_spread_term_sums": ("badger_amcl_tpu_torch/csrc/pc_spread_term_sums.cu",
                                "badger_amcl_tpu/ops/pc_spread_kernel.py:490"),
        "beam_table": ("badger_amcl_tpu_torch/csrc/beam_table.cu",
                       "badger_amcl_tpu/ops/beam_kernel.py:132"),
        "beam_spread_sums": ("badger_amcl_tpu_torch/csrc/beam_spread_sums.cu",
                             "badger_amcl_tpu/ops/beam_spread_kernel.py:150"),
        "fleet_corr_table": ("badger_amcl_tpu_torch/csrc/corr_table.cu",
                             "badger_amcl_tpu/ops/corr_kernel.py:366"),
        "corr_table_q": ("badger_amcl_tpu_torch/csrc/corr_table.cu",
                         "badger_amcl_tpu/ops/corr_kernel.py:489"),
        # the native host hook of the JAX package, not a TPU kernel
        "edt_2d": ("badger_amcl_tpu_torch/csrc/edt.cu", "badger_amcl_tpu/utils/native.py:68"),
        "edt_3d": ("badger_amcl_tpu_torch/csrc/edt.cu", "badger_amcl_tpu/utils/native.py:68"),
        # the lax.while_loop of the JAX package's cluster labelling, not a
        # TPU kernel
        "cluster_labels": ("badger_amcl_tpu_torch/csrc/cluster_labels.cu",
                           "badger_amcl_tpu/pf/cluster.py:72"),
    }
    for k in meta:
        if k not in OFF_MAIN_PATH:
            check(launches[k]["launches"] > 0, f"{k} was not launched on any main path")
    line = {"kernels": [
        {"name": k, "route": "cuda", "source": meta[k][0], "replaces": meta[k][1],
         **launches[k], **kernels[k],
         **({"main_path": False, "note": OFF_MAIN_PATH[k]} if k in OFF_MAIN_PATH else {})}
        for k in meta]}
    timings["command_s"] = time.perf_counter() - t_start
    log(json.dumps({"timings": timings}))
    log(f"chip_smoke: every phase passed in {timings['command_s']:.1f} s of command time "
        f"(the interpreter's start aside)")
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--fleet-rank"]:  # one rank of phase_sharded_fleet
            code = fleet_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        else:
            code = main()
    except Failure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        code = 1
    sys.exit(code)
