"""PyTorch port: the sharded fleet (`fleet.make_sharded_fleet_step`,
`fleet_health(group=...)`, `shard_robots`, `gather_robots`,
`fleet_reinit_masked` on a shard) over torch.distributed, two gloo ranks in
subprocesses (tests/torch_fleet_rank.py) joined through a file store in the
test's temporary directory, held against the port's one-process
`fleet_step` and the JAX package's `make_sharded_fleet_step` and
`fleet_health(mesh=...)` on a 2-device mesh.

The JAX fleet step draws from each robot's key; the test replays those
draws for the whole fleet (tests/test_torch_fleet.py:349-361) and every
rank takes its rows of that one draw (`shard_robots`).

Tolerances:
- a rank's robots against the one-process step on the same variates:
  poses within 1e-6, n_active equal (the same code on the same rows);
- against JAX (its "xla" backend, the port's "exact"), the tolerance
  tests/test_torch_fleet.py holds fleet_step to: n_active equal, >= 99%
  of poses within 1e-4, set means within 1e-4 (f32 trig and likelihood
  sums differ in the last ulp, and the steps carry that into the picks);
- fleet health against JAX's on the same states: rtol 1e-6.
"""

import functools
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from badger_amcl_tpu.fleet import fleet as jfleet
from badger_amcl_tpu.maps import CellState
from badger_amcl_tpu.maps import OccupancyMap2D as JaxMap
from badger_amcl_tpu.pf.types import PFParams as JaxPFParams
from badger_amcl_tpu.sensors import planar as jplanar
from badger_amcl_tpu_torch import convert
from badger_amcl_tpu_torch import fleet as tfleet

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parent.parent
R, M, B, STEPS, WORLD = 4, 512, 32, 3, 2
RANGE_MAX = 6.0
RANK_TIMEOUT_S = 120
MEANS = np.array([[0.0, 0.0, 0.1], [2.5, -1.5, 1.2], [-3.0, 2.0, -0.7], [1.0, 4.0, 2.9]],
                 np.float32)
JPARAMS = JaxPFParams(min_samples=16, max_samples=M, hist_x=32, hist_y=32,
                      stats_max_clusters=64)
ALPHAS = (0.05,) * 5
DELTAS = np.tile(np.array([0.05, 0.0, 0.01], np.float32), (R, 1))


def _world():
    """The 448^2 map of tests/test_torch_fleet.py baked for the likelihood
    field, a 32-beam scan per robot, the fleet from JAX's fleet_init."""
    rng = np.random.default_rng(7)
    n = 448
    cells = np.full((n, n), int(CellState.FREE), np.int8)
    cells[0:2, :] = cells[-2:, :] = int(CellState.OCCUPIED)
    cells[:, 0:2] = cells[:, -2:] = int(CellState.OCCUPIED)
    for _ in range(12):
        cx, cy = rng.integers(20, n - 28, 2)
        cells[cy:cy + 6, cx:cx + 6] = int(CellState.OCCUPIED)
    jmap = JaxMap.from_cells(cells, 0.05).with_distance_field(2.0)
    jsp = jplanar.PlanarScanParams()
    jmap = jplanar.bake_corr_texture(jmap, jsp, RANGE_MAX, "likelihood_field")
    angles = jnp.linspace(-2.0, 2.0, B)
    ranges = jnp.stack([jnp.clip(1.2 + 0.5 * jnp.sin(angles * (2.0 + i)), 0.3, 2.5)
                        for i in range(R)])
    jscans = jplanar.PlanarScan(ranges=ranges.astype(jnp.float32),
                                angles=jnp.tile(angles, (R, 1)).astype(jnp.float32),
                                range_max=jnp.full((R,), RANGE_MAX, jnp.float32))
    covs = np.tile(np.diag([0.02, 0.02, 0.002]).astype(np.float32), (R, 1, 1))
    js = jfleet.fleet_init(JPARAMS, jax.random.PRNGKey(1), jnp.asarray(MEANS),
                           jnp.asarray(covs))
    return jmap, jsp, jscans, js


def _step_noise(keys):
    """The JAX fleet step's draws per robot (tests/test_torch_fleet.py
    :349-361): the motion split (odom.py:144), then the resample head's
    (filter.py:585-596); returns (FleetNoise, keys after the step)."""
    normals, inject, pick, after = [], [], [], []
    for k in keys:
        k1, sub = jax.random.split(k)
        normals.append(np.stack([np.asarray(jax.random.normal(kk, (M,), dtype=jnp.float32))
                                 for kk in jax.random.split(sub, 3)]))
        _, sub = jax.random.split(k1)
        u1, u2 = jax.random.split(sub)
        inject.append(np.asarray(jax.random.uniform(u1, (M,))))
        pick.append(np.asarray(jax.random.uniform(u2, (M,))))
        after.append(jax.random.split(k1)[0])
    return tfleet.FleetNoise(*(torch.from_numpy(np.stack(x)) for x in (normals, inject, pick))
                             ), after


@functools.lru_cache(maxsize=None)
def _mesh():
    return Mesh(np.array(jax.devices()[:WORLD]), ("fleet",))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX's sharded fleet on the 2-device mesh, the port's one-process
    fleet_step on both backends, and the two gloo ranks on the same job."""
    jmap, jsp, jscans, js0 = _world()
    pools = np.random.default_rng(4).uniform(-3, 3, (R, M, 3)).astype(np.float32)
    zeros = np.zeros((R, 3), np.float32)
    jstep = jfleet.make_sharded_fleet_step(_mesh(), JPARAMS, backend="xla")
    js, keys, noises = js0, list(js0.key), []
    for _ in range(STEPS):
        js = jstep(js, jmap, jsp, jscans, jnp.asarray(pools), jnp.asarray(zeros),
                   jnp.asarray(DELTAS), jnp.asarray(DELTAS), jnp.full((5,), 0.05))
        noise, keys = _step_noise(keys)
        noises.append(noise)
    extra_noise, _ = _step_noise(keys)
    tmap = convert.map_from_numpy(jmap, device="cpu")
    job = dict(
        omap=tmap, sp=convert.scan_params_from_numpy(jsp),
        params=convert.pf_params_from_jax(JPARAMS), alphas=ALPHAS,
        states=convert.state_from_numpy(js0, device="cpu"),
        scans=convert.fleet_scan_from_numpy(jscans, device="cpu"),
        pools=torch.from_numpy(pools), odom_poses=torch.from_numpy(zeros),
        deltas=torch.from_numpy(DELTAS), noises=noises, extra_noise=extra_noise,
        health_states=convert.state_from_numpy(js, device="cpu"),
        mask=torch.tensor([True, False, False, True]),
        pose_pools=torch.from_numpy(
            np.random.default_rng(5).uniform(-2, 2, (R, M, 3)).astype(np.float32)))
    root = tmp_path_factory.mktemp("sharded_fleet")
    torch.save(job, root / "job.pt")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_fleet_rank.py"),
                               str(rank), str(WORLD), str(root)], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for rank in range(WORLD)]
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=RANK_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"a gloo rank ran past {RANK_TIMEOUT_S} s")
        errs.append(err)
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err
    ranks = [torch.load(root / f"rank{rank}.pt", weights_only=False) for rank in range(WORLD)]

    one_process = {}
    for backend in ("exact", "corr"):
        ts = job["states"]
        for noise in noises:
            ts = tfleet.fleet_step(ts, tmap, job["sp"], job["scans"], job["pools"],
                                   job["odom_poses"], job["deltas"], job["deltas"], ALPHAS,
                                   job["params"], backend=backend, noise=noise)
        one_process[backend] = ts
    return dict(job=job, ranks=ranks, one=one_process, jax=js)


@pytest.mark.parametrize("backend", ["exact", "corr"])
def test_ranks_equal_one_process_step(run, backend):
    """Each rank's robots after 3 steps equal their rows of the one-process
    fleet_step on the same variates; gather_robots reads the whole fleet
    back in rank order."""
    want = run["one"][backend]
    per = R // WORLD
    for rank, out in enumerate(run["ranks"]):
        own, rows = out[backend]["own"], slice(rank * per, (rank + 1) * per)
        assert own.poses.shape == (per, M, 3)
        np.testing.assert_allclose(own.poses.numpy(), want.poses[rows].numpy(), rtol=0,
                                   atol=1e-6)
        assert torch.equal(own.n_active, want.n_active[rows])
        whole = out[backend]["whole"]
        assert torch.equal(whole.poses[rows], own.poses)
        assert torch.equal(whole.stats.cluster_count[rows], own.stats.cluster_count)
        assert whole.converged.dtype == torch.bool
    assert torch.equal(run["ranks"][0][backend]["whole"].poses,
                       run["ranks"][1][backend]["whole"].poses)


def test_ranks_match_jax_sharded_step(run):
    """The ranks' fleet (gathered) on "exact" against JAX's
    make_sharded_fleet_step on "xla" over the 2-device mesh."""
    got, want = run["ranks"][0]["exact"]["whole"], run["jax"]
    assert len(want.poses.sharding.device_set) == WORLD
    np.testing.assert_array_equal(got.n_active.numpy(), np.asarray(want.n_active))
    close = (np.abs(got.poses.numpy() - np.asarray(want.poses)) <= 1e-4).all(-1)
    assert close.mean() >= 0.99, close.mean()
    np.testing.assert_allclose(got.stats.mean.numpy()[:, :2],
                               np.asarray(want.stats.mean)[:, :2], atol=1e-4)


def test_fleet_health_group_matches_jax_mesh(run):
    """fleet_health(group=...) over the ranks' shards of JAX's final states
    equals JAX's fleet_health(mesh=...) of them, and on every rank; the
    health of the ranks' own run equals the one-process fleet's."""
    want = jfleet.fleet_health(run["jax"], mesh=_mesh())
    for out in run["ranks"]:
        for k, v in want.items():
            np.testing.assert_allclose(float(out["health_jax_states"][k]), float(v),
                                       rtol=1e-6, err_msg=k)
        local = tfleet.fleet_health(run["one"]["corr"])
        for k, v in local.items():
            assert out["corr"]["health"][k].device.type == "cpu"  # gloo reduces on the CPU
            np.testing.assert_allclose(float(out["corr"]["health"][k]), float(v), rtol=1e-6,
                                       err_msg=k)


def test_reinit_on_shard_leaves_unmasked_robots(run):
    """fleet_reinit_masked on each rank's shard: after one more step the
    robots outside the mask are bit-identical to a run without the reinit
    (tests/test_fleet.py:221), the masked ones restarted from their pools."""
    mask = run["job"]["mask"]
    per = R // WORLD
    for rank, out in enumerate(run["ranks"]):
        m = mask[rank * per:(rank + 1) * per]
        a, b = out["reinit"]["with_"], out["reinit"]["without"]
        assert m.any() and (~m).any()
        for f in ("poses", "weights", "n_active", "w_slow", "w_fast", "converged"):
            assert torch.equal(getattr(a, f)[~m], getattr(b, f)[~m]), f
        assert not torch.equal(a.poses[m], b.poses[m])


def test_misuse_raises(run):
    """A robot count the world size does not divide (in shard_robots and in
    the factory), a rank given another count than n_robots / world, a
    backend outside FLEET_BACKENDS and tensors off the rank's device all
    raise, on every rank."""
    for out in run["ranks"]:
        assert out["raises"] == dict(shard_3_robots=True, n_robots_3=True, backend_lf=True,
                                     wrong_count=True, off_device=True)
