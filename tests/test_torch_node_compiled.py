"""PyTorch port: the nodes' compiled helpers on the CPU.

The JAX package's nodes call seven `jax.jit` helpers; the port's node
modules hold them as `utils.graph.graph_jit` entries of the same names
(node.py: `_motion_update_jit`, `_resample_jit`, `_uniform_pool_jit`;
node_2d.py and node_3d.py: `_sensor_update_jit`, `_score_poses_jit`). On
the CPU a graph_jit entry runs its function eagerly, so each is held here
against its JAX counterpart on the same inputs, the draws replayed from
the JAX keys, on the recorded streams of tests/test_torch_node_2d.py
(1000 particles x 40 beams) and tests/test_torch_node_3d.py (800 x 128
points):

- the motion models' poses within 1e-5 (XLA's and PyTorch's f32 trig
  differ in the last ulp); the uniform pool within 1e-6 (XLA fuses its
  multiply-adds);
- the resamplers' poses, weights and counts exact, the set's mean within
  rtol 1e-4 / atol 1e-5 of the JAX package's, its covariance within 1e-4
  (the stream's cloud sits 3 m from the origin, where both packages'
  one-pass f32 moments lose up to 7e-5 to cancellation against the
  float64 covariance of the same set: a sum order apart);
- likelihoods and updated weights rtol 1e-5.

Also: the 3D windowed predicate (`pc.fits`) as a cond taking both arms;
whole node scans under `control.StrictHostReads`, whose only host reads
are the node's own (the JAX node's `int()`, `bool()`, `np.asarray`) and,
eagerly, the dispatch predicates; the node's compiled decision for each
configuration family; `graph_jit.release` and the nodes releasing every
map and free-cell table they replace; the max-weight cluster picked on
the device.
"""

import collections
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_node_2d as n2
import test_torch_node_3d as n3
from badger_amcl_tpu.node import node as jnode
from badger_amcl_tpu.node import node_2d as jnode2
from badger_amcl_tpu.node import node_3d as jnode3
from badger_amcl_tpu.node.transforms import Transform as JaxTransform
from badger_amcl_tpu.pf.filter import ResampleModel as JaxResampleModel
from badger_amcl_tpu.sensors import odom as jodom
from badger_amcl_tpu_torch import cli, config, convert, scenario
from badger_amcl_tpu_torch.node import make_node
from badger_amcl_tpu_torch.node import node as tnode
from badger_amcl_tpu_torch.node import node_2d as tnode2
from badger_amcl_tpu_torch.node import node_3d as tnode3
from badger_amcl_tpu_torch.node.transforms import Transform
from badger_amcl_tpu_torch.pf import filter as pf_filter
from badger_amcl_tpu_torch.pf.filter import ResampleModel
from badger_amcl_tpu_torch.sensors import odom as todom
from badger_amcl_tpu_torch.sensors import point_cloud
from badger_amcl_tpu_torch.utils import control
from badger_amcl_tpu_torch.utils.graph import Entry, graph_jit
from badger_amcl_tpu_torch.utils.numerics import SYNCS

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
stream = n2.stream
world = n3.world
# the recovery averages set before a resample: w_diff = 1 - w_fast / w_slow
W_DIFF = {"no_injection": (0.0, 0.0), "injection": (1e-3, 5e-4)}


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def node2d(stream):
    """(jax node, port node) after the same four scans on the 2D stream, the
    port's state converted from the JAX node's."""
    grid, steps = stream
    jn, jtf, tn, ttf = n2._nodes(grid, {"resample_interval": 1000})
    for step in steps[:5]:
        n2._feed(jn, jtf, JaxTransform, step, False)
        n2._feed(tn, ttf, Transform, step, True)
    tn.state = convert.state_from_numpy(jn.state, device="cpu")
    return jn, tn


@pytest.fixture(scope="module")
def node3d(world):
    """(jax node, port node) after the same three clouds on the 3D stream,
    the port's state converted from the JAX node's."""
    pts, steps, _ = world
    jn, jtf, tn, ttf = n3._nodes({"resample_interval": 1000}, pts=pts)
    for step in steps[:4]:
        n3._feed(jn, jtf, JaxTransform, step, False)
        n3._feed(tn, ttf, Transform, step, True)
    tn.state = convert.state_from_numpy(jn.state, device="cpu")
    return jn, tn


def _jax_pool(jn, key, m):
    return jnode._uniform_pool_jit(key, jn.free_space_indices, *jn._fsi_geom,
                                   jnp.zeros((m,), jnp.float32))


# --- node.py: the motion model, the resampler, the uniform pool -----------------


@pytest.mark.parametrize("model", list(todom.OdomModel))
def test_motion_update_jit_matches(node2d, model):
    """Each of the five odometry models, its three normal draws replayed
    from the JAX state's key."""
    jn, tn = node2d
    m = jn.state.poses.shape[0]
    alphas = (0.2, 0.1, 0.15, 0.05, 0.1)
    pose, delta, absolute = ([0.4, -0.2, 0.3], [0.12, 0.03, 0.05], [0.13, 0.04, 0.06])
    j = jnode._motion_update_jit(jn.state, jodom.OdomModel(int(model)), list(alphas),
                                 *(jnp.asarray(v, jnp.float32) for v in (pose, delta, absolute)))
    _, sub = jax.random.split(jn.state.key)
    normals = torch.from_numpy(np.stack(
        [np.asarray(jax.random.normal(k, (m,), dtype=jnp.float32))
         for k in jax.random.split(sub, 3)]))
    t = tnode._motion_update_jit(tn.state, model, alphas,
                                 *(torch.tensor(v, dtype=torch.float32) for v in (pose, delta)),
                                 normals, torch.tensor(absolute, dtype=torch.float32))
    np.testing.assert_allclose(t.poses.numpy(), np.asarray(j.poses), rtol=0, atol=1e-5)
    assert torch.equal(t.weights, tn.state.weights)


@pytest.mark.parametrize("w_diff", list(W_DIFF))
@pytest.mark.parametrize("model", [ResampleModel.MULTINOMIAL, ResampleModel.SYSTEMATIC])
def test_resample_jit_matches(node2d, model, w_diff):
    """Both resamplers on the updated 2D set, with and without injection
    from a uniform pool; the uniforms (multinomial) or the comb's start
    (systematic) replayed from the JAX resample's key."""
    jn, tn = node2d
    w_slow, w_fast = W_DIFF[w_diff]
    jstate = jn.state.replace(w_slow=jnp.float32(w_slow), w_fast=jnp.float32(w_fast))
    tstate = tn.state.replace(w_slow=torch.tensor(w_slow), w_fast=torch.tensor(w_fast))
    m = jn.params.max_samples
    jpool = _jax_pool(jn, jax.random.PRNGKey(7), m)
    j = jnode._resample_jit(jstate, jn.params, jpool, JaxResampleModel(int(model)), False)
    _, sub = jax.random.split(jstate.key)
    if model == ResampleModel.SYSTEMATIC:
        kw = dict(u_start=_t(jax.random.uniform(sub, ())))
    else:
        k1, k2 = jax.random.split(sub)
        kw = dict(u_inject=_t(jax.random.uniform(k1, (m,))),
                  u_pick=_t(jax.random.uniform(k2, (m,))))
    t = tnode._resample_jit(tstate, tn.params, _t(jpool), model=model, log_averages=False, **kw)
    n = int(j.n_active)
    assert int(t.n_active) == n
    np.testing.assert_array_equal(t.poses.numpy(), np.asarray(j.poses))
    np.testing.assert_array_equal(t.weights.numpy(), np.asarray(j.weights))
    for f in ("w_slow", "w_fast", "converged"):
        assert float(getattr(t, f)) == float(getattr(j, f)), f
    assert int(t.stats.cluster_count) == int(j.stats.cluster_count)
    np.testing.assert_allclose(t.stats.mean.numpy(), np.asarray(j.stats.mean), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(t.stats.cov.numpy(), np.asarray(j.stats.cov), rtol=0, atol=1e-4)
    from_pool = (t.poses[:n, None, :] == _t(jpool)[None]).all(-1).any(-1)
    assert bool(from_pool.any()) == (w_diff == "injection")


def test_uniform_pool_jit_matches(node2d):
    """The node's free cells held by reference; the two uniforms replayed
    from the JAX key."""
    jn, tn = node2d
    m = jn.params.max_samples
    key = jax.random.PRNGKey(3)
    want = np.asarray(_jax_pool(jn, key, m))
    k1, k2 = jax.random.split(key)
    got = tnode._uniform_pool_jit(_t(jax.random.uniform(k1, (m,))),
                                  _t(jax.random.uniform(k2, (m,))), tn.free_space_indices,
                                  *tn._fsi_geom)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


# --- node_2d.py and node_3d.py: the sensor update and the pose score ------------

MODELS = ["likelihood_field", "likelihood_field_gompertz"]


@pytest.mark.parametrize("model", MODELS)
def test_sensor_update_2d_jit_matches(node2d, model):
    jn, tn = node2d
    j = jnode2._sensor_update_jit(jn.state, jn.map, jn.scanner_params[0], jn.latest_scan,
                                  model, False, "xla")
    t = tnode2._sensor_update_jit(tn.state, tn.map, tn.scanner_params[0], tn.latest_scan,
                                  model, False, "exact")
    np.testing.assert_allclose(t.weights.numpy(), np.asarray(j.weights), rtol=1e-5, atol=0)
    for f in ("w_slow", "w_fast"):
        np.testing.assert_allclose(float(getattr(t, f)), float(getattr(j, f)), rtol=1e-5)


@pytest.mark.parametrize("model", MODELS)
def test_score_poses_2d_jit_matches(node2d, model):
    """A uniform pool scored with the base params: the rejection rounds'
    likelihoods."""
    jn, tn = node2d
    jpool = _jax_pool(jn, jax.random.PRNGKey(5), 512)
    j = jnode2._score_poses_jit(jn.map, jn._base_params, jn.latest_scan, jpool, model, False,
                                "xla")
    t = tnode2._score_poses_jit(tn.map, tn._base_params, tn.latest_scan, _t(jpool), model,
                                False, "exact")
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=0)


@pytest.mark.parametrize("model", MODELS)
def test_sensor_update_3d_jit_matches(node3d, model):
    """The JAX node's XLA gather against the port's exact gather and its
    "corr" dispatch (the plain versions of #9 / #10 here)."""
    jn, tn = node3d
    j = jnode3._sensor_update_jit(jn.state, jn.map, jn.pc_params, jn.latest_points_base,
                                  model, "xla")
    for backend in ("exact", "corr"):
        t = tnode3._sensor_update_jit(tn.state, tn.map, tn.pc_params, tn.latest_points_base,
                                      model, backend)
        np.testing.assert_allclose(t.weights.numpy(), np.asarray(j.weights), rtol=1e-5,
                                   atol=0, err_msg=backend)


def test_score_poses_3d_jit_matches(node3d):
    jn, tn = node3d
    jpool = _jax_pool(jn, jax.random.PRNGKey(9), 400)
    model = tn.config.point_cloud_model_type.value
    j = jnode3._score_poses_jit(jn.map, jn.pc_params, jn.latest_points_base, jpool, model,
                                "xla")
    t = tnode3._score_poses_jit(tn.map, tn.pc_params, tn.latest_points_base, _t(jpool),
                                model, "exact")
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=0)


@pytest.mark.parametrize("arm,cov", [("true", (0.004, 0.004, 0.0004)),
                                     ("false", (2.0, 2.0, 1.0))])
def test_pc_fits_cond_takes_both_arms(arm, cov):
    """The windowed predicate is one cond, `pc.fits`: a tight cloud takes
    #9's fused sums, a spread one #10's sums; each equals the exact gather
    (rtol 1e-5); an eager call reads the predicate in one host sync."""
    omap, _, state, cloud, pcp, _ = scenario.build_setup_3d(256, pose_cov=cov, device="cpu")
    want, _ = point_cloud.point_cloud_likelihood(omap, pcp, cloud, state.poses,
                                                 "likelihood_field_gompertz", "exact")
    arms, s0 = collections.Counter(control.ARMS), SYNCS.count
    with control.StrictHostReads() as mode:
        got, mf = point_cloud.point_cloud_likelihood(omap, pcp, cloud, state.poses,
                                                     "likelihood_field_gompertz", "corr")
    assert SYNCS.count - s0 == mode.reads == 1
    assert +(collections.Counter(control.ARMS) - arms) == {f"pc.fits:{arm}": 1}
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=0)
    # warm-up mode runs both arms and returns the one the predicate picks
    with control.all_arms():
        both, _ = point_cloud.point_cloud_likelihood(omap, pcp, cloud, state.poses,
                                                     "likelihood_field_gompertz", "corr")
    assert torch.equal(both, got)


# --- whole scans under the strict mode -----------------------------------------

# the node's own reads (node.py), each one counted host sync
NODE_READS = ("publish_particle_cloud", "get_max_weight_pose", "update_pose",
              "random_pose_pool", "resample_particles")
REJECTION = dict(resample_interval=2, uniform_pose_starting_weight_threshold=0.8,
                 uniform_pose_deweight_multiplier=0.98)


@pytest.fixture
def node_reads(monkeypatch):
    """The node's host reads by the node method that makes them."""
    reads = collections.Counter()

    def counted(fn):
        def read(*ts):
            reads[sys._getframe(1).f_code.co_name] += 1
            with control._nested("allowed"):
                return fn(*ts)
        return read

    monkeypatch.setattr(tnode, "host_arrays", counted(tnode.host_arrays))
    monkeypatch.setattr(tnode, "host_bool", counted(tnode.host_bool))
    return reads


def _strict_scans(node, feed, steps, reads):
    """Feed each step under StrictHostReads: per scan (resampled, the
    node's reads, the predicate reads); asserts that nothing else reads
    the host (a tensor made from host data, the scan and the odometry, is
    an upload) and that SYNCS counts every read."""
    out = []
    for step in steps:
        reads.clear()
        r0, s0 = node.resample_count, SYNCS.count
        with control.StrictHostReads(raise_on_read=False) as mode:
            feed(step)
        assert set(mode.untracked) <= {"aten.lift_fresh.default"}, mode.untracked
        assert SYNCS.count - s0 == mode.reads + sum(reads.values())
        assert set(reads) <= set(NODE_READS), reads
        resampled = node.resample_count > r0 and node.resample_count % 2 == 0
        out.append((resampled, dict(reads), mode.reads))
    return out


def _check_scan_kinds(rows):
    """Update-only scans read the particle cloud; resampling scans also run
    at least one rejection round and publish the pose."""
    kinds = {r[0] for r in rows}
    assert kinds == {True, False}, rows
    for resampled, reads, _ in rows:
        if resampled:
            assert reads.get("random_pose_pool", 0) >= 1 and reads["get_max_weight_pose"] == 1
            assert reads["update_pose"] == 1
        elif reads:
            assert reads.get("publish_particle_cloud", 0) <= 1
            assert "random_pose_pool" not in reads


def test_strict_node_scans_2d(stream, node_reads):
    grid, steps = stream
    _, _, tn, ttf = n2._nodes(grid, dict(REJECTION, update_min_d=0.01, update_min_a=0.01))
    assert tn.compiled
    rows = _strict_scans(tn, lambda s: n2._feed(tn, ttf, Transform, s, True), steps[:7],
                         node_reads)
    _check_scan_kinds(rows)
    # global localization: the convergence flag is read after each resample
    tn.global_localization()
    rows = _strict_scans(tn, lambda s: n2._feed(tn, ttf, Transform, s, True), steps[7:10],
                         node_reads)
    assert any(r[1].get("resample_particles") for r in rows if r[0])


def test_strict_node_scans_3d(world, node_reads):
    pts, steps, _ = world
    _, _, tn, ttf = n3._nodes(dict(REJECTION, update_min_d=0.01, update_min_a=0.01,
                                   compute_backend="pallas_corr"), pts=pts,
                              port=dict(compute_backend="corr"))
    assert tn.compiled and tn.backend == "corr"
    rows = _strict_scans(tn, lambda s: n3._feed(tn, ttf, Transform, s, True), steps[:5],
                         node_reads)
    _check_scan_kinds(rows)


# --- the compiled decision, the release of graph entries ------------------------

DECISIONS = {
    "2d_default": (lambda: config.AMCLConfig(), True),
    "amcl_2d_yaml": (lambda: cli.load_config(os.path.join(ROOT, "examples", "amcl_2d.yaml")),
                     True),
    "2d_lf_backend": (lambda: config.AMCLConfig(compute_backend="pallas"), True),
    "beam": (lambda: config.AMCLConfig(laser_model_type="beam"), False),
    "prob_log_space": (lambda: config.AMCLConfig(laser_model_type="likelihood_field_prob",
                                                 laser_likelihood_log_space=True), False),
    "corr_q": (lambda: config.AMCLConfig(compute_backend="pallas_corr_q"), False),
    "beamskip": (lambda: config.AMCLConfig(do_beamskip=True), False),
    "3d_default": (lambda: config.AMCLConfig.for_3d(), True),
    "amcl_3d_yaml": (lambda: cli.load_config(os.path.join(ROOT, "examples", "amcl_3d.yaml")),
                     True),
    "3d_corr_q": (lambda: config.AMCLConfig.for_3d(compute_backend="pallas_corr_q"), True),
}


@pytest.mark.parametrize("family", list(DECISIONS))
def test_node_compiled_decision(family, tmp_path):
    make_cfg, compiled = DECISIONS[family]
    cfg = make_cfg().replace(saved_pose_filepath=str(tmp_path / "pose.yaml"))
    node = make_node(cfg, device="cpu")
    assert node.compiled is compiled, node.compiled_reason
    if not compiled:
        assert "slice" in node.compiled_reason


def test_reconfigure_decides_again(tmp_path):
    cfg = config.AMCLConfig(saved_pose_filepath=str(tmp_path / "pose.yaml"))
    node = make_node(cfg, device="cpu")
    assert node.compiled
    node.reconfigure(cfg.replace(laser_model_type="beam"))
    assert not node.compiled and "beam" in node.compiled_reason
    node.reconfigure(restore_defaults=True)
    assert node.compiled


def test_graph_jit_release():
    """release(obj) drops exactly the entries holding obj by reference and
    gives their capture pools back; CPU tensors run the function eagerly
    and make no entry."""
    class FakeCapture:
        released = 0

        def release(self):
            self.released += 1

    jit = graph_jit(lambda x, omap, fsi: x + 1, static_argnames=())
    a, b = object(), object()
    caps = [FakeCapture() for _ in range(3)]
    for key, (cap, refs) in enumerate(zip(caps, ({"omap": a, "fsi": b}, {"omap": b},
                                                 {"omap": a}))):
        jit.entries[key] = Entry(None, [], None, cap, refs, 0.0)
    assert jit.release(a) == 2 and list(jit.entries) == [1]
    assert [c.released for c in caps] == [1, 0, 1]
    assert jit.release(a) == 0 and jit.release(b) == 1 and not jit.entries
    x = torch.ones(2)
    assert torch.equal(jit(x, a, b), x + 1) and not jit.entries


def test_nodes_release_what_they_replace(stream, monkeypatch):
    """Every map and free-cell table a node replaces (the first scan's
    bake on "corr", a second map receipt) is released from each of the
    node's helpers."""
    released = collections.defaultdict(list)
    for jit in tnode2.Node2D.JITS:
        monkeypatch.setattr(jit, "release", lambda obj, jit=jit: released[jit].append(obj) or 0)
    grid, steps = stream
    _, _, tn, ttf = n2._nodes(grid, {"compute_backend": "pallas_corr"},
                              port={"compute_backend": "corr"})
    assert len(tnode2.Node2D.JITS) == 5 and tn.backend == "corr"
    first_map, first_fsi = tn.map, tn.free_space_indices
    for step in steps[:2]:
        n2._feed(tn, ttf, Transform, step, True)
    baked = tn.map
    assert baked is not first_map and baked.factor_tex is not None
    tn.map_msg_received(convert.message_from_jax(grid))
    for jit in tnode2.Node2D.JITS:
        objs = released[jit]
        for old in (first_map, first_fsi, baked):
            assert any(o is old for o in objs), jit.__name__
        assert not any(o is tn.map or o is tn.free_space_indices for o in objs)


def test_max_weight_cluster_reads_nothing(node2d):
    """The published pose's cluster is picked on the device: no host read
    until the node reads the pair (a 0-dim index tensor would read itself
    to the host)."""
    _, tn = node2d
    stats = tn.state.stats
    with control.StrictHostReads():
        w, mean = pf_filter.max_weight_cluster(stats)
    k = int(torch.argmax(stats.cluster_weights))
    assert float(w) == float(stats.cluster_weights[k])
    assert torch.equal(mean, stats.cluster_means[k])
