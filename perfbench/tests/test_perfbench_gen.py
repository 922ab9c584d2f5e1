"""The store, the lap, the stream and the raycasters repeat for one seed."""

import hashlib
import math

import numpy as np
import pytest
import torch

from perfbench.gen import raycast, route, store


def _digest(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 11])
def test_store_repeats_for_a_seed(seed):
    g1, g2 = store.grid(500, 320, seed), store.grid(500, 320, seed)
    assert _digest(g1) == _digest(g2)
    assert set(np.unique(g1)) == {-1, 0, 100}
    v1, v2 = store.voxels(200, 150, 12, seed), store.voxels(200, 150, 12, seed)
    assert _digest(v1) == _digest(v2)
    assert v1[:, 2].min() == 0 and v1[:, 2].max() == 11


def test_store_differs_between_seeds():
    assert _digest(store.grid(500, 320, 1)) != _digest(store.grid(500, 320, 2))


def test_lap_is_closed_and_keeps_to_the_turn_rate():
    lap = route.gondola_loop((2000, 1200), 0.05, 0, 0.5, 15.0, 1.0, 0.5)
    steps = np.diff(np.vstack([lap.poses, lap.poses[:1]]), axis=0)
    dist = np.hypot(steps[:, 0], steps[:, 1])
    turn = np.abs(np.arctan2(np.sin(steps[:, 2]), np.cos(steps[:, 2])))
    assert dist.max() < 0.5 / 15 * 1.001 and dist.min() > 0.5 / 15 * 0.95
    assert (turn / (1 / 15)).max() <= 0.5 * 1.01
    x0, x1, y0, y1 = lap.gondola
    # the lap keeps to the aisles: never inside the gondola's box
    inside = ((lap.poses[:, 0] > x0 * 0.05) & (lap.poses[:, 0] < x1 * 0.05)
              & (lap.poses[:, 1] > y0 * 0.05) & (lap.poses[:, 1] < y1 * 0.05))
    assert not inside.any()
    with pytest.raises(ValueError):
        route.gondola_loop((2000, 1200), 0.05, 0, 0.5, 15.0, 0.5, 0.5)


@pytest.mark.parametrize("steps", [500, 1600])
def test_stream_repeats_for_a_seed(steps):
    lap = route.gondola_loop((2000, 1200), 0.05, 0, 0.5, 15.0, 1.0, 0.5)
    a = route.stream(lap, steps, 2 ** 31 + 7, 15.0, [0.002, 0.002, 0.001])
    b = route.stream(lap, steps, 2 ** 31 + 7, 15.0, [0.002, 0.002, 0.001])
    c = route.stream(lap, steps, 8, 15.0, [0.002, 0.002, 0.001])
    assert np.array_equal(a.lap_index, b.lap_index) and np.array_equal(a.odom, b.odom)
    assert not np.array_equal(a.odom, c.odom)
    # one lap sample a step, round the lap and on past its end
    assert np.all(np.diff(a.lap_index) % len(lap.poses) == 1)
    d = np.hypot(*np.diff(a.odom[:, :2], axis=0).T)
    assert d.max() < 0.05


def test_planar_raycast_repeats_and_hits_the_wall():
    occ = torch.zeros((40, 60), dtype=torch.bool)
    occ[:, 50] = True  # a wall at x = 2.5 m (cells of 0.05 m, supersampled by 2)
    poses = np.array([[1.0, 1.0, 0.0], [1.0, 1.0, math.pi]])
    angles = np.array([0.0, 0.3])

    def cast(seed):
        return raycast.planar_ranges(occ, 0.05, 2, poses, angles, 5.0, 0.0,
                                     torch.Generator().manual_seed(seed))

    r = cast(1)
    assert np.array_equal(r, cast(1))
    assert abs(r[0, 0] - (2.5 - 0.0125 - 1.0)) <= 0.026
    assert abs(r[0, 1] - r[0, 0] / math.cos(0.3)) <= 0.03
    assert (r[1] == 5.0).all()  # facing away: no return within range


def test_lidar_raycast_repeats_and_lands_on_surfaces():
    nx, ny, nz = 80, 60, 20
    tops = torch.zeros((nx, ny), dtype=torch.int32)
    tops[60, :] = 15  # a face at x = 3 m
    poses = np.array([[1.0, 1.5, 0.0]])
    el = np.deg2rad(np.array([-15.0, 0.0, 10.0]))
    az = np.array([0.0, math.pi])

    def cast(seed):
        return raycast.lidar_clouds(tops, nz, 0.05, poses, 0.5, el, az, 8.0, 0.0,
                                    torch.Generator().manual_seed(seed))

    (c,) = cast(3)
    assert np.array_equal(c, cast(3)[0])
    # the floor ahead and behind for the lower ring, the face for the level one
    down = c[np.isclose(c[:, 2], c[:, 2].min())]
    assert np.allclose(down[:, 2], -(0.5 - 0.025), atol=0.03)
    level = c[np.abs(c[:, 2]) < 1e-6]
    assert np.allclose(level[level[:, 0] > 0][:, 0], 3.0 - 0.025 - 1.0, atol=0.03)
