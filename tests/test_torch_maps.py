"""PyTorch port: EDT copy, map, scenario builder and the no-JAX import
contract, held against the JAX package on the same inputs.

Tolerances: cells and distances are integer/EDT arithmetic done the same
way in numpy on both sides, so they must be bit-equal; the psi and factor
textures and the scan go through exp/sin, whose f32 implementations differ
between XLA and PyTorch in the last ulp, hence atol 1e-6.
"""

import pathlib
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _build_setup
from badger_amcl_tpu.maps import edt as jax_edt
from badger_amcl_tpu_torch import convert, scenario
from badger_amcl_tpu_torch.maps import edt
from badger_amcl_tpu_torch.pf import filter as pf_filter

torch.set_num_threads(1)


def test_capped_distance_field_bit_equal():
    rng = np.random.default_rng(5)
    occ = rng.random((61, 83)) < 0.03
    got = edt.capped_distance_field(occ, 0.05, 1.0)
    want = jax_edt.capped_distance_field(occ, 0.05, 1.0)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def both_setups():
    kw = dict(n_particles=512, n_beams=180, seed=0)
    j = _build_setup(kw["n_particles"], kw["n_beams"], 448, seed=kw["seed"])
    t = scenario.build_setup(kw["n_particles"], kw["n_beams"], 448, seed=kw["seed"],
                             device="cpu")
    return j, t


def test_scenario_map_and_textures_match(both_setups):
    (jmap, jparams, _, jscan, jsp, jpool), (tmap, tparams, _, tscan, tsp, tpool) = both_setups
    np.testing.assert_array_equal(tmap.cells.numpy(), np.asarray(jmap.cells))
    np.testing.assert_array_equal(tmap.distances.numpy(), np.asarray(jmap.distances))
    assert tmap.corr_psi_key == jmap.corr_psi_key
    assert tmap.factor_key == jmap.factor_key
    np.testing.assert_allclose(tmap.corr_psi_pad.numpy(), np.asarray(jmap.corr_psi_pad),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(tmap.factor_tex.numpy(), np.asarray(jmap.factor_tex),
                               rtol=0, atol=1e-6)
    assert convert.pf_params_from_jax(jparams) == tparams
    assert convert.scan_params_from_numpy(jsp) == tsp
    np.testing.assert_allclose(tscan.angles.numpy(), np.asarray(jscan.angles), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tscan.ranges.numpy(), np.asarray(jscan.ranges), rtol=0,
                               atol=1e-6)
    assert tscan.range_max == float(jscan.range_max)
    assert tuple(tpool.shape) == tuple(jpool.shape)
    assert float(tpool.min()) >= -3.0 and float(tpool.max()) < 3.0


def test_converted_map_equals_scenario_map(both_setups):
    (jmap, *_), (tmap, *_) = both_setups
    cmap = convert.map_from_numpy(jmap, device="cpu")
    for f in ("resolution", "size_x", "size_y", "origin_x", "origin_y",
              "max_distance_to_object", "corr_psi_key", "factor_key"):
        assert getattr(cmap, f) == getattr(tmap, f), f
    assert torch.equal(cmap.cells, tmap.cells)


def test_world_to_map_and_distance_at(both_setups):
    (jmap, *_), (tmap, *_) = both_setups
    rng = np.random.default_rng(2)
    xy = rng.uniform(-13.0, 13.0, (4000, 2)).astype(np.float32)  # some off-map
    ij_j = np.asarray(jmap.world_to_map(jnp.asarray(xy)))
    ij_t = tmap.world_to_map(torch.from_numpy(xy))
    np.testing.assert_array_equal(ij_t.numpy(), ij_j)
    np.testing.assert_array_equal(tmap.is_valid(ij_t).numpy(),
                                  np.asarray(jmap.is_valid(jnp.asarray(ij_j))))
    np.testing.assert_array_equal(tmap.distance_at(ij_t).numpy(),
                                  np.asarray(jmap.distance_at(jnp.asarray(ij_j))))


def test_init_with_poses_stats_match(both_setups):
    (_, jparams, jstate, *_), (_, tparams, *_) = both_setups
    st = pf_filter.init_with_poses(tparams, torch.tensor(np.asarray(jstate.poses)))
    js = jstate.stats
    assert int(st.stats.cluster_count) == int(js.cluster_count)
    np.testing.assert_array_equal(st.stats.particle_cluster.numpy(),
                                  np.asarray(js.particle_cluster))
    np.testing.assert_allclose(st.stats.mean.numpy(), np.asarray(js.mean), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(st.stats.cov.numpy(), np.asarray(js.cov), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_array_equal(st.weights.numpy(), np.asarray(jstate.weights))


def test_port_imports_no_jax():
    """Importing every port module and running a CPU step (2D, eager and
    through `sensor_resample_step_jit`, 3D, the
    maps' distance fields, beam, a corr_q likelihood, a fleet step, a cell-contract step under
    `profiling.trace`, the compiled fleet step, the cell contract with the
    capped statistics through `sensor_resample_step_jit`, a one-rank gloo
    sharded fleet step and its health,
    corr_q, the prob model, the beam model, beam skipping and the node's
    log-space update through the compiled entries, a
    few Node2D scans with systematic resampling and a few Node3D scans on a
    .bt octomap from the simulator, both through the nodes' compiled
    helpers, and a three-step `cli.main --sim`) must work with JAX and the
    JAX package made unimportable."""
    code = textwrap.dedent("""
        import os
        import sys
        sys.modules["jax"] = None
        sys.modules["badger_amcl_tpu"] = None
        import torch
        torch.set_num_threads(1)
        import badger_amcl_tpu_torch
        from badger_amcl_tpu_torch import convert, mcl, scenario
        from badger_amcl_tpu_torch.ops import _build, corr_kernel, lf_kernel, spread_kernel
        omap, params, state, scan, sp, pool = scenario.build_setup(
            256, 64, 448, pose_cov=(0.02, 0.02, 0.002), min_particles=256,
            device="cpu")
        gen = torch.Generator().manual_seed(0)
        out = mcl.mcl_step_2d(state, omap, sp, scan, pool, [0.1, 0.0, 0.02],
                              [0.1, 0.0, 0.02], None, [0.1] * 5, params,
                              backend="corr", generator=gen)
        assert torch.isfinite(out.weights).all()
        from badger_amcl_tpu_torch.ops import cluster_kernel  # noqa: F401
        from badger_amcl_tpu_torch.ops import graph_cond  # noqa: F401
        from badger_amcl_tpu_torch.utils import control, graph, tree  # noqa: F401
        out = mcl.sensor_resample_step_jit(state, omap, sp, scan, pool, params,
                                           backend="corr", generator=gen)
        # both 2D steps took the corr table's arm
        assert torch.isfinite(out.weights).all() and control.ARMS["corr.fits:true"] == 2
        from badger_amcl_tpu_torch.ops import pc_kernel, pc_spread_kernel
        from badger_amcl_tpu_torch.sensors import point_cloud
        omap3, _, state3, cloud, pcp, _ = scenario.build_setup_3d(
            256, pose_cov=(0.004, 0.004, 0.0004), device="cpu")
        p, mf = point_cloud.point_cloud_likelihood(
            omap3, pcp, cloud, state3.poses, "likelihood_field_gompertz", backend="corr")
        assert p.shape == (256,) and torch.isfinite(p).all() and (mf == 1.0).all()
        from badger_amcl_tpu_torch.ops import edt_kernel
        assert torch.equal(edt_kernel.capped_field_2d(omap.cells, omap.resolution,
                                                      scenario.MAX_DIST), omap.distances)
        assert torch.equal(edt_kernel.voxel_texture_3d(
            omap3.occupancy_volume(), omap3.resolution, omap3.max_distance_to_object),
            omap3.tex_zyx)
        from badger_amcl_tpu_torch.ops import beam_kernel, beam_spread_kernel
        from badger_amcl_tpu_torch.sensors import planar, raycast
        bmap = scenario.build_map(256, device="cpu", range_image_bins=64)
        assert planar.beam_arm(bmap, scan, state.poses) == "table"
        out = mcl.mcl_step_2d(state, bmap, sp, scan, pool, [0.1, 0.0, 0.02],
                              [0.1, 0.0, 0.02], None, [0.1] * 5, params,
                              laser_model="beam", backend="corr", generator=gen)
        assert torch.isfinite(out.weights).all()
        p, _ = planar.planar_likelihood(omap, sp, scan, state.poses, state.active_mask,
                                        state.n_active, backend="corr_q")
        assert omap.corr_psi_pad_q is not None and torch.isfinite(p).all()
        # the models the compiled step took in last, each through a compiled
        # entry (eager on the CPU): corr_q, prob (linear), the beam model,
        # beam skipping, and the node's log-space sensor update
        for mp, kw in ((omap, dict(backend="corr_q")),
                       (omap, dict(laser_model="likelihood_field_prob")),
                       (bmap, dict(laser_model="beam"))):
            out = mcl.sensor_resample_step_jit(state, mp, sp, scan, pool, params,
                                               generator=gen, **{"backend": "corr", **kw})
            assert torch.isfinite(out.weights).all()
        # each took its kernel's arm, as the eager calls above did
        assert control.ARMS["corr_q.window.narrow:true"] == 2
        assert control.ARMS["beam.fits:true"] == 2
        out = mcl.mcl_step_2d_jit(state.replace(converged=torch.tensor(True)), omap, sp,
                                  scan, pool, [0.1, 0.0, 0.02], [0.1, 0.0, 0.02], None,
                                  [0.1] * 5, params, laser_model="likelihood_field_prob",
                                  do_beamskip=True, backend="corr", generator=gen)
        assert torch.isfinite(out.weights).all()
        from badger_amcl_tpu_torch.node import node_2d
        out = node_2d._sensor_update_jit(state, omap, sp, scan, "likelihood_field_prob",
                                         True, "corr", log_space=True)
        assert torch.isfinite(out.weights).all()
        from badger_amcl_tpu_torch import fleet
        fparams = type(params)(min_samples=16, max_samples=256, hist_x=32, hist_y=32,
                               stats_max_clusters=64)
        cov = [[0.02, 0.0, 0.0], [0.0, 0.02, 0.0], [0.0, 0.0, 0.002]]
        fs = fleet.fleet_init(fparams, [[0.0, 0.0, 0.0], [0.5, 0.2, 0.1]], [cov, cov],
                              generator=gen, device="cpu")
        odom = torch.tensor([[0.05, 0.0, 0.01]] * 2)
        fs = fleet.fleet_step(fs, omap, sp, fleet.FleetScan.tile(scan, 2),
                              torch.zeros(2, 256, 3), torch.zeros(2, 3), odom, odom,
                              [0.05] * 5, fparams, backend="corr", generator=gen)
        assert fs.poses.shape == (2, 256, 3) and torch.isfinite(fs.weights).all()
        # the compiled fleet step (eager on the CPU) takes the batched table too
        fs = fleet.make_fleet_step(fparams, backend="corr")(
            fs, omap, sp, fleet.FleetScan.tile(scan, 2), torch.zeros(2, 256, 3),
            torch.zeros(2, 3), odom, odom, [0.05] * 5, generator=gen)
        assert torch.isfinite(fs.weights).all() and control.ARMS["fleet.fits:true"] == 2
        import tempfile
        from badger_amcl_tpu_torch.pf import filter as pf_filter
        from badger_amcl_tpu_torch.utils import profiling
        with tempfile.TemporaryDirectory() as d:
            with profiling.trace(d):
                out = mcl.sensor_resample_step(state, omap, sp, scan, pool, params,
                                               backend="corr", resample_contract="cell",
                                               generator=gen)
            assert len(os.listdir(d)) == 1
            group = fleet.init_fleet_group("file://" + d + "/store", 1, 0, device="cpu")
            step = fleet.make_sharded_fleet_step(group, fparams, device="cpu", n_robots=2)
            fs = step(fleet.shard_robots(fs, group), omap, sp, fleet.FleetScan.tile(scan, 2),
                      torch.zeros(2, 256, 3), torch.zeros(2, 3), odom, odom, [0.05] * 5,
                      generator=gen)
            health = fleet.fleet_health(fs, group)
            assert float(health["mean_active"]) == float(fs.n_active.float().mean())
            assert torch.equal(fleet.gather_robots(fs, group).poses, fs.poses)
            torch.distributed.destroy_process_group()
        assert pf_filter.CELL_ARMS["cell"] == 1 and torch.isfinite(out.weights).all()
        # the cell contract and the capped statistics through the compiled entry
        import dataclasses
        out = mcl.sensor_resample_step_jit(state, omap, sp, scan, pool,
                                           dataclasses.replace(params, stats_max_clusters=8),
                                           backend="corr", resample_contract="cell",
                                           generator=gen)
        assert control.ARMS["cells.ok:true"] == 2 and torch.isfinite(out.weights).all()
        import numpy as np
        from badger_amcl_tpu_torch import config
        from badger_amcl_tpu_torch.node import (checkpoint, make_node, messages,
                                                persistence, scan_prep, transforms)
        from badger_amcl_tpu_torch.utils import profiling
        tfb = transforms.TransformBuffer()
        tfb.set_static("base_link", "laser", transforms.Transform.identity())
        cfg = config.AMCLConfig(min_particles=256, max_particles=256, laser_max_beams=64,
                                update_min_d=0.01, resample_interval=1,
                                resample_model_type="systematic",
                                saved_pose_filepath="/nonexistent/saved_pose.yaml")
        node = make_node(cfg, tf_buffer=tfb, device="cpu")
        assert node.compiled  # the graph_jit helpers, eager on the CPU
        node.init_pose = np.array([0.5, -0.5, 0.2])
        node.init_cov = np.array([0.01, 0.01, 0.005])
        node.map_msg_received(scenario.grid_msg(448))
        poses = []
        node.subscribe_output("amcl_pose", poses.append)
        pose = node.init_pose.copy()
        angles = np.linspace(-2.35, 2.35, 64).astype(np.float32)
        for k in range(1, 4):
            pose = pose + np.array([0.05, 0.0, 0.0])
            tfb.set_transform("odom", "base_link", 0.1 * k,
                              transforms.Transform.from_pose2d(pose))
            node.integrate_odom(messages.Odometry(0.1 * k, pose.copy()))
            node.scan_received(scenario.laser_scan(omap, pose, angles, 0.1 * k))
        assert len(poses) >= 2 and np.isfinite(poses[-1].pose).all()
        assert torch.isfinite(node.state.weights).all()
        from badger_amcl_tpu_torch import __main__, cli, sim  # noqa: F401
        from badger_amcl_tpu_torch.maps import octree_io
        from badger_amcl_tpu_torch.node import node_3d, ros_bridge
        occ = np.random.default_rng(1).uniform(0.0, 4.0, (600, 3))
        with tempfile.TemporaryDirectory() as d:
            octree_io.write_bt(d + "/m.bt", 0.1, occ)
            payload = open(d + "/m.bt", "rb").read()
        s3 = sim.Sim3D(occ, 0.1, start_pose=(2.0, 2.0, 0.3), n_points=64)
        cfg3 = config.AMCLConfig.for_3d(min_particles=256, max_particles=256,
                                        laser_max_beams=32, update_min_d=0.01,
                                        saved_pose_filepath="/nonexistent/saved_pose.yaml")
        node3 = make_node(cfg3, tf_buffer=s3.tf, device="cpu")
        assert isinstance(node3, node_3d.Node3D) and node3.compiled
        node3.init_pose = s3.true_pose.copy()
        node3.octomap_msg_received(messages.OctomapMsg(resolution=0.1, binary_data=payload))
        poses3 = []
        node3.subscribe_output("amcl_pose", poses3.append)
        for _ in range(3):
            node3.integrate_odom(s3.step(0.2, 0.1))
            node3.scan_received(s3.make_cloud())
        assert len(poses3) >= 2 and torch.isfinite(node3.state.weights).all()
        assert cli.main(["--sim", "--steps", "3", "--device", "cpu", "--seed", "0"]) == 0
        assert callable(ros_bridge.run_ros_bridge)
        assert not any(m == "jax" or m.startswith(("jax.", "badger_amcl_tpu."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300,
                          cwd=pathlib.Path(__file__).resolve().parent.parent)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
