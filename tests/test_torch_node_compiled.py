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
import dataclasses
import gc
import os
import sys
import weakref

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
from badger_amcl_tpu_torch.utils import control, graph, tree
from badger_amcl_tpu_torch.utils.graph import Entry, Packed, graph_jit
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
    """The node's host reads by the node method that makes them; the
    flags `resample_particles` read, in order, under `reads.flags`."""
    reads = collections.Counter()
    reads.flags = []

    def counted(fn):
        def read(*ts):
            name = sys._getframe(1).f_code.co_name
            reads[name] += 1
            with control._nested("allowed"):
                out = fn(*ts)
            if name == "resample_particles":
                reads.flags.append(out)
            return out
        return read

    monkeypatch.setattr(tnode, "host_arrays", counted(tnode.host_arrays))
    monkeypatch.setattr(tnode, "host_bool", counted(tnode.host_bool))
    return reads


def _strict_scans(node, feed, steps, reads):
    """Feed each step under StrictHostReads: per scan (resampled, the
    node's reads, the predicate reads, the flags resample_particles read);
    asserts that nothing else reads the host (a tensor made from host
    data, the scan and the odometry, is an upload) and that SYNCS counts
    every read."""
    out = []
    for step in steps:
        reads.clear()
        reads.flags = []
        r0, s0 = node.resample_count, SYNCS.count
        with control.StrictHostReads(raise_on_read=False) as mode:
            feed(step)
        assert set(mode.untracked) <= {"aten.lift_fresh.default"}, mode.untracked
        assert SYNCS.count - s0 == mode.reads + sum(reads.values())
        assert set(reads) <= set(NODE_READS), reads
        resampled = node.resample_count > r0 and node.resample_count % 2 == 0
        out.append((resampled, dict(reads), mode.reads, reads.flags))
    return out


def _check_scan_kinds(rows, global_localization=False):
    """Update-only scans read the particle cloud; resampling scans read
    w_diff > 0 once (in global localization the convergence flag after
    it, until that holds), run at least one rejection round if and only
    if w_diff > 0, and publish the pose."""
    if not global_localization:
        assert {r[0] for r in rows} == {True, False}, rows
    for resampled, reads, _, flags in rows:
        if resampled:
            assert reads["resample_particles"] == len(flags) in (
                (1, 2) if global_localization else (1,)), rows
            assert (reads.get("random_pose_pool", 0) >= 1) == flags[0], rows
            assert reads["get_max_weight_pose"] == 1 and reads["update_pose"] == 1
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
    _check_scan_kinds(rows, global_localization=True)
    assert any(len(r[3]) == 2 for r in rows if r[0])


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
    "beam": (lambda: config.AMCLConfig(laser_model_type="beam"), True),
    "prob_log_space": (lambda: config.AMCLConfig(laser_model_type="likelihood_field_prob",
                                                 laser_likelihood_log_space=True), True),
    "corr_q": (lambda: config.AMCLConfig(compute_backend="pallas_corr_q"), True),
    "beamskip": (lambda: config.AMCLConfig(do_beamskip=True), True),
    "3d_default": (lambda: config.AMCLConfig.for_3d(), True),
    "amcl_3d_yaml": (lambda: cli.load_config(os.path.join(ROOT, "examples", "amcl_3d.yaml")),
                     True),
    "3d_corr_q": (lambda: config.AMCLConfig.for_3d(compute_backend="pallas_corr_q"), True),
}


def _capped_params(monkeypatch):
    """Nodes built from here on carry a cluster cap (no configuration key
    sets one: the fleet's scenario does)."""
    pf_params = tnode.Node._pf_params
    monkeypatch.setattr(tnode.Node, "_pf_params", staticmethod(
        lambda cfg: dataclasses.replace(pf_params(cfg), stats_max_clusters=8)))


@pytest.mark.parametrize("family", list(DECISIONS) + ["2d_capped", "3d_capped"])
def test_node_compiled_decision(family, tmp_path, monkeypatch):
    """Every 2D and 3D configuration runs compiled, the capped statistics
    too."""
    if family.endswith("_capped"):
        make_cfg, compiled = DECISIONS[family.replace("capped", "default")][0], True
        _capped_params(monkeypatch)
    else:
        make_cfg, compiled = DECISIONS[family]
    cfg = make_cfg().replace(saved_pose_filepath=str(tmp_path / "pose.yaml"))
    node = make_node(cfg, device="cpu")
    assert node.compiled is compiled
    if family.endswith("_capped"):
        assert node.params.stats_max_clusters == 8


def test_reconfigure_decides_again(tmp_path, monkeypatch):
    cfg = config.AMCLConfig(saved_pose_filepath=str(tmp_path / "pose.yaml"))
    node = make_node(cfg, device="cpu")
    assert node.compiled
    node.reconfigure(cfg.replace(laser_model_type="beam"))
    assert node.compiled  # the beam model compiles
    _capped_params(monkeypatch)
    node.reconfigure(cfg.replace(laser_model_type="beam"))
    assert node.compiled and node.params.stats_max_clusters == 8  # the cap too
    monkeypatch.undo()
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


# --- the bound on the entries, their release by configuration and by node -----


class FakeCapture:
    """A capture record without a card: counts its releases."""

    slots = {}
    launches = {}  # it attributes no kernel launches

    def __init__(self):
        self.released = 0

    def release(self):
        self.released += 1


class FakeGraph:
    """A replay without a card: the function run again on the entry's
    buffers, its outputs packed into the entry's slots."""

    def __init__(self, run, outputs):
        self.run, self.outputs = run, outputs

    def replay(self):
        self.outputs.pack(tree.leaves(self.run()))


def _fake_capture(fn, bound, leaves, spec, references, kernels, static):
    inputs = [t.clone(memory_format=torch.contiguous_format) for t in leaves]
    args = dict(bound.arguments, **tree.unflatten(spec, inputs))
    out_spec, out_leaves = tree.flatten(fn(**args))
    outputs = Packed(out_spec, out_leaves)
    return Entry(FakeGraph(lambda: fn(**args), outputs), inputs, outputs, FakeCapture(),
                 references, 0.0, static=static)


NODE_JITS = tnode2.Node2D.JITS + tnode3.Node3D.JITS[3:]


@pytest.fixture
def fake_graphs(monkeypatch):
    """graph_jit's compiled path on CPU tensors (a fake capture and replay):
    the node helpers' entries, keys, eviction and release as on the card.
    The helpers' entries are cleared after the test."""
    monkeypatch.setattr(graph, "_captures_on", lambda device: True)
    monkeypatch.setattr(graph, "_capture", _fake_capture)
    yield
    for jit in NODE_JITS:
        jit.entries.clear()


def test_graph_jit_bounds_its_entries(fake_graphs, monkeypatch):
    """Past MAX_ENTRIES keys the least recently used entry goes (its
    capture released); a call that hits a key makes it the most recent;
    the replayed values are the function's."""
    monkeypatch.setattr(graph, "MAX_ENTRIES", 3)
    jit = graph_jit(lambda x, k: x * k, static_argnames=("k",))
    for n in range(1, 6):
        assert torch.equal(jit(torch.ones(n), 2.0), torch.full((n,), 2.0))
        assert len(jit.entries) <= 3
    assert jit.captures == 5 and jit.evictions == 2
    assert [key[-1][0][0][0] for key in jit.entries] == [3, 4, 5]
    jit(torch.ones(3), 2.0)  # a hit: 3 is now the most recent, 4 the least
    evicted = next(iter(jit.entries.values())).capture
    jit(torch.ones(6), 2.0)
    assert evicted.released == 1 and jit.captures == 6
    assert [key[-1][0][0][0] for key in jit.entries] == [5, 3, 6]
    assert torch.equal(jit(torch.arange(3.0), 2.0), torch.arange(3.0) * 2)


@pytest.mark.parametrize("where", ["capture", "replay"])
def test_graph_jit_defers_a_release_inside_a_call(where, fake_graphs, monkeypatch):
    """A release that fires inside a call (a node collected there: in the
    capture of a new key, or between a live key's lookup and its replay)
    waits for the call's end: the call replays the entry it looked up, then
    the released entry goes with its capture released."""
    jit = graph_jit(lambda x: x + 1, static_argnames=())
    x = torch.zeros(2)
    if where == "capture":
        victim = Entry(None, [], None, FakeCapture(), {"omap": "m"}, 0.0)
        jit.entries["old"] = victim

        def capture(*args):
            assert jit.release("m") == 1 and jit.entries["old"] is victim
            return _fake_capture(*args)

        monkeypatch.setattr(graph, "_capture", capture)
    else:
        jit(x)
        ((key, victim),) = jit.entries.items()
        victim.references["omap"] = "m"

        class Releasing:
            """A graph whose replay fires the release, then replays."""

            def __init__(self, graph):
                self.graph = graph

            def replay(self):
                assert jit.release("m") == 1 and jit.entries[key] is victim
                self.graph.replay()

        victim.graph = Releasing(victim.graph)
    assert torch.equal(jit(x), torch.ones(2))
    assert all(e is not victim for e in jit.entries.values()) and victim.capture.released == 1
    assert not graph._PENDING and not graph._DEFERRED and not graph._busy[0]


def test_graph_jit_release_where():
    """release_where drops exactly the entries whose static arguments the
    predicate accepts."""
    jit = graph_jit(lambda x, a, b: x, static_argnames=("a", "b"))
    caps = [FakeCapture() for _ in range(3)]
    for key, (cap, static) in enumerate(zip(caps, ({"a": 1, "b": 0}, {"a": 2, "b": 0},
                                                   {"a": 1, "b": 1}))):
        jit.entries[key] = Entry(None, [], None, cap, {}, 0.0, static=static)
    assert jit.release_where(lambda st: st["a"] == 1) == 2 and list(jit.entries) == [1]
    assert [c.released for c in caps] == [1, 0, 1]
    assert jit.release_where(lambda st: st["a"] == 1) == 0
    jit.entries.clear()


def test_cloud_sizes_beyond_the_bound(world, fake_graphs, monkeypatch):
    """A stream of more distinct cloud sizes than the bound: each 3D
    helper keeps at most MAX_ENTRIES entries, every size captured once
    while it lives, the likelihoods those of the eager helper."""
    monkeypatch.setattr(graph, "MAX_ENTRIES", 4)
    pts, steps, _ = world
    _, _, tn, ttf = n3._nodes({"resample_interval": 1000}, pts=pts)
    n3._feed(tn, ttf, Transform, steps[1], True)
    cloud = tn.latest_points_base
    model = tn.config.point_cloud_model_type.value
    sizes = list(range(40, 40 + 3 * graph.MAX_ENTRIES))
    captures0 = tnode3._score_poses_jit.captures
    for n in sizes + sizes[-2:]:
        got = tnode3._score_poses_jit(tn.map, tn.pc_params, cloud[:n], tn.state.poses, model,
                                      tn.backend)
        want = tnode3._score_poses_jit.__wrapped__(tn.map, tn.pc_params, cloud[:n],
                                                   tn.state.poses, model, tn.backend)
        assert torch.equal(got, want)
        assert len(tnode3._score_poses_jit.entries) <= graph.MAX_ENTRIES
    # the last two sizes hit their live keys
    assert tnode3._score_poses_jit.captures - captures0 == len(sizes)
    assert len(tnode3._score_poses_jit.entries) == graph.MAX_ENTRIES


def _node_with_entries(tmp_path, **kw):
    """A CPU 2D node after two scans through its helpers and a uniform
    pool, compiled on fake graphs: entries that hold its map and free
    cells, and entries keyed on its alphas and PFParams (`kw` overrides
    the configuration). The pool is built here since a resample builds it
    only where w_diff > 0."""
    cfg = config.AMCLConfig(max_particles=500, min_particles=100, laser_max_beams=30,
                            resample_interval=1, saved_pose_filepath=str(tmp_path / "pose.yaml"),
                            uniform_pose_starting_weight_threshold=0.0)
    node = make_node(cfg.replace(**kw), device="cpu")
    node.tf.set_static("base_link", "laser", Transform.identity())
    node.map_msg_received(scenario.grid_msg(128))
    omap = node.map
    angles = np.linspace(-2.0, 2.0, 30).astype(np.float32)
    for k in range(3):
        pose = np.array([0.3 * k, 0.0, 0.0])
        node.tf.set_transform("odom", "base_link", 0.1 * k, Transform.from_pose2d(pose))
        node.integrate_odom(tnode.Odometry(0.1 * k, pose))
        node.scan_received(scenario.laser_scan(omap, pose, angles, 0.1 * k))
    node.random_pose_pool()
    return node


def _holding(obj):
    return sum(1 for jit in NODE_JITS for e in jit.entries.values()
               for v in e.references.values() if v is obj)


@pytest.mark.parametrize("how", ["shutdown", "collected"])
def test_a_node_that_goes_releases_its_map(how, fake_graphs, tmp_path):
    """A node shut down, or dropped and collected, leaves no entry that
    holds its map or free cells, and a dropped node's map is freed (a
    module-level helper keeps nothing of it)."""
    node = _node_with_entries(tmp_path)
    assert node.compiled and node.resample_count >= 2
    omap, fsi = weakref.ref(node.map), weakref.ref(node.free_space_indices)
    assert _holding(omap()) >= 1 and _holding(fsi()) >= 1
    if how == "shutdown":
        node.shutdown(1.0)
        assert _holding(omap()) == 0 and _holding(fsi()) == 0
    del node
    gc.collect()
    assert omap() is None and fsi() is None


def _keyed(jit, name, value):
    return sum(1 for e in jit.entries.values() if e.static.get(name) == value)


# alphas no other node of the suite holds (a held value's entries stay)
OWN_ALPHAS = {"odom_alpha5": 0.0123}


def test_reconfigure_releases_the_old_configuration(fake_graphs, tmp_path):
    """reconfigure drops the motion model's entries keyed on the old alphas
    and the resampler's keyed on the old PFParams (its max_samples among
    them); an entry keyed on other alphas stays."""
    node = _node_with_entries(tmp_path, **OWN_ALPHAS)
    other = Entry(None, [], None, FakeCapture(), {}, 0.0,
                  static={"model": todom.OdomModel.DIFF, "alphas": (9.0,) * 5})
    tnode._motion_update_jit.entries["other"] = other
    old_params = node.params
    old_alphas = tnode._alphas(node.config)
    assert _keyed(tnode._motion_update_jit, "alphas", old_alphas) >= 1
    assert _keyed(tnode._resample_jit, "params", old_params) >= 1
    node.reconfigure(node.config.replace(odom_alpha1=0.5, max_particles=400))
    assert _keyed(tnode._motion_update_jit, "alphas", old_alphas) == 0
    assert _keyed(tnode._resample_jit, "params", old_params) == 0
    assert "other" in tnode._motion_update_jit.entries and other.capture.released == 0


@pytest.mark.parametrize("how", ["laser_model", "twin_reconfigured", "twin_collected",
                                 "last_collected"])
def test_config_entries_go_with_their_last_holder(how, fake_graphs, tmp_path):
    """The entries keyed on a node's alphas and PFParams stay while a live
    node holds those values: a reconfiguration that keeps them (a new laser
    model) drops none, and a twin of the same configuration that is
    reconfigured or collected leaves the node's entries alone; they go when
    the last holder is collected."""
    node = _node_with_entries(tmp_path, **OWN_ALPHAS)
    alphas, params = tnode._alphas(node.config), node.params
    held = {"alphas": _keyed(tnode._motion_update_jit, "alphas", alphas),
            "params": _keyed(tnode._resample_jit, "params", params)}
    assert held["alphas"] >= 1 and held["params"] >= 1
    if how == "laser_model":
        node.reconfigure(node.config.replace(laser_model_type="likelihood_field_prob"))
        assert node.params == params
    elif how == "last_collected":
        del node
        gc.collect()
        held = {"alphas": 0, "params": 0}
    else:
        twin = make_node(node.config, device="cpu")
        if how == "twin_reconfigured":
            twin.reconfigure(twin.config.replace(odom_alpha1=0.5, max_particles=400))
        del twin
        gc.collect()
    assert _keyed(tnode._motion_update_jit, "alphas", alphas) == held["alphas"]
    assert _keyed(tnode._resample_jit, "params", params) == held["params"]


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
