"""The robot's route through the store and the stream of sensor steps that
a run replays.

The lap is a closed loop around one seeded gondola: along the aisle below
its row, up the cross aisle past its right end, back along the aisle above
and down the cross aisle past its left end, with quarter turns of radius
`turn_radius_m` at the corners. One lap is sampled once a sensor period at
constant speed; a run then replays it lap after lap.

The stream maps each sensor step n (simulated time n / rate) to the lap
sample the robot is at, from a seeded first one, and to its odometry.
Odometry integrates the true motion of each step plus seeded Gaussian
noise, so it drifts as a robot's does; it is continuous across laps and
across kidnaps, where the robot is carried to another part of its lap.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from perfbench.gen import store


@dataclasses.dataclass
class Lap:
    poses: np.ndarray  # (N, 3) float64 world x, y, yaw of each sensor step
    length_m: float
    gondola: tuple  # (x0, x1, y0, y1) cells of the gondola the lap goes round


@dataclasses.dataclass
class Stream:
    lap_index: np.ndarray  # (S,) int64 lap sample of each step
    odom: np.ndarray  # (S, 3) float64 odometry pose of each step
    dt: float


def gondola_loop(cells: tuple, resolution: float, seed: int, speed: float, rate_hz: float,
                 turn_radius: float, max_turn_rate: float) -> Lap:
    """The lap round a seeded gondola of the store of `cells` (w, h)."""
    if speed / turn_radius > max_turn_rate + 1e-12:
        raise ValueError("the turn radius needs a faster turn than the traffic allows")
    w, h = cells
    boxes = store.gondolas(w, h, seed)
    rows = sorted({b[2] for b in boxes})
    rng = np.random.default_rng(seed + 10)
    # a row with an aisle below it (the front area below the first row holds pallets)
    row = rows[int(rng.integers(1, len(rows)))] if len(rows) > 1 else rows[0]
    in_row = [b for b in boxes if b[2] == row]
    x0, x1, y0, y1 = in_row[int(rng.integers(0, len(in_row)))]
    # the cross aisles' centres (3 m gaps) and the aisles' centres (2 m), metres
    xl, xr = (x0 - 30) * resolution, (x1 + 30) * resolution
    yb, yt = (y0 - 20) * resolution, (y1 + 20) * resolution
    r = turn_radius
    # straight legs and quarter arcs, counter-clockwise from the bottom-left
    legs = [((xl + r, yb), (xr - r, yb)), ((xr, yb + r), (xr, yt - r)),
            ((xr - r, yt), (xl + r, yt)), ((xl, yt - r), (xl, yb + r))]
    arcs = [(xr - r, yb + r, -math.pi / 2), (xr - r, yt - r, 0.0),
            (xl + r, yt - r, math.pi / 2), (xl + r, yb + r, math.pi)]
    straight = [math.hypot(b[0] - a[0], b[1] - a[1]) for a, b in legs]
    arc_len = math.pi / 2 * r
    length = sum(straight) + 4 * arc_len
    n = max(8, int(round(length / (speed / rate_hz))))
    s = np.arange(n) * (length / n)
    poses = np.empty((n, 3))
    edges = np.cumsum([0.0] + [v for k in range(4) for v in (straight[k], arc_len)])
    for k in range(4):
        (ax, ay), (bx, by) = legs[k]
        heading = math.atan2(by - ay, bx - ax)
        on = (s >= edges[2 * k]) & (s < edges[2 * k + 1])
        u = (s[on] - edges[2 * k]) / straight[k]
        poses[on] = np.stack([ax + u * (bx - ax), ay + u * (by - ay),
                              np.full(u.shape, heading)], axis=1)
        cx, cy, a0 = arcs[k]
        on = (s >= edges[2 * k + 1]) & (s < edges[2 * k + 2])
        phi = a0 + (s[on] - edges[2 * k + 1]) / r
        poses[on] = np.stack([cx + r * np.cos(phi), cy + r * np.sin(phi),
                              phi + math.pi / 2], axis=1)
    poses[:, 2] = np.arctan2(np.sin(poses[:, 2]), np.cos(poses[:, 2]))
    return Lap(poses=poses, length_m=length, gondola=(x0, x1, y0, y1))


def _relative(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """b in the frame of a, per row: (dx, dy, dyaw)."""
    c, s = np.cos(a[:, 2]), np.sin(a[:, 2])
    dx, dy = b[:, 0] - a[:, 0], b[:, 1] - a[:, 1]
    dth = np.arctan2(np.sin(b[:, 2] - a[:, 2]), np.cos(b[:, 2] - a[:, 2]))
    return np.stack([c * dx + s * dy, -s * dx + c * dy, dth], axis=1)


def kidnap_steps(steps: int, every: int) -> np.ndarray:
    """The steps at which the robot is kidnapped: every `every`-th step
    counted from the first (step 0 is never one); none where every is 0
    or None."""
    return np.arange(every, steps, every) if every else np.zeros(0, np.int64)


def stream(lap: Lap, steps: int, seed: int, rate_hz: float, odom_noise,
           kidnap_every: int = None) -> Stream:
    """`steps` sensor steps along the lap from a seeded sample of it. With
    `kidnap_every`, at each of `kidnap_steps` the robot jumps to a seeded
    lap sample at least a quarter lap from where it was, and goes on round
    the lap from there."""
    n = len(lap.poses)
    rng = np.random.default_rng(seed + 20)
    first = int(rng.integers(0, n))
    idx = (first + np.arange(steps)) % n
    at = kidnap_steps(steps, kidnap_every)
    if len(at):
        jump = np.zeros(steps, np.int64)
        jump[at] = np.random.default_rng(seed + 22).integers(n // 4, n - n // 4 + 1, len(at))
        idx = (idx + np.cumsum(jump)) % n
    # the odometry of a step is the lap's own step into the step's sample,
    # with noise: wheel odometry does not see a kidnap
    step = _relative(lap.poses[(idx - 1) % n], lap.poses[idx])
    step += np.random.default_rng(seed + 21).standard_normal((steps, 3)) * np.asarray(odom_noise)
    step[0] = 0.0
    x0, y0, th0 = lap.poses[first]
    th = th0 + np.cumsum(step[:, 2])
    th_prev = np.concatenate([[th0], th[:-1]])
    c, s = np.cos(th_prev), np.sin(th_prev)
    odom = np.empty((steps, 3))
    odom[:, 0] = x0 + np.cumsum(c * step[:, 0] - s * step[:, 1])
    odom[:, 1] = y0 + np.cumsum(s * step[:, 0] + c * step[:, 1])
    odom[:, 2] = np.arctan2(np.sin(th), np.cos(th))
    return Stream(lap_index=idx.astype(np.int64), odom=odom, dt=1.0 / rate_hz)
