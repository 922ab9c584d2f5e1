"""Minimal OctoMap reader/writer: binary (.bt) and full (.ot) formats (a
copy of badger_amcl_tpu.maps.octree_io, numpy only, with writers that
scale).

Replaces the reference's dependency on the `octomap` / `octomap_msgs` C++
libraries (used at node_3d.cpp:262-284 to decode map messages — the
`binary ? binaryMsgToMap : fullMsgToMap` branch).

Binary (.bt) stream: an ASCII header followed by a depth-first node stream
where every inner node contributes two bytes — two bits per child: 0b00
absent, 0b01 occupied leaf, 0b10 free leaf, 0b11 inner child (recursed in
child order 0..7).

Full (.ot, id OcTree) stream: ASCII header, then a depth-first node stream
where every node contributes a 4-byte little-endian float (log-odds
occupancy) and a 1-byte child-allocation mask (bit i set = child i present,
recursed 0..7). A leaf is occupied when its log-odds exceeds octomap's
default occupancy threshold of 0.5 probability = 0.0 log-odds
(AbstractOccupancyOcTree::isNodeOccupied, used at octomap.cpp:222).

Child index convention matches octomap: bit0 -> +x half, bit1 -> +y half,
bit2 -> +z half; tree depth 16, center key 32768, leaf center coordinate
(key - 32768 + 0.5) * resolution.

The writers emit the JAX package's bytes. Where its writers test every
inner cube against the whole key set (one scan of the K keys per cube),
these list the tree's nodes per depth as the distinct Morton prefixes of
the keys and order them depth first by sorting, so a scene of tens of
thousands of voxels is written in well under a second.
"""

from __future__ import annotations

import io
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

_HEADER_ID = "# Octomap OcTree binary file"
_FULL_HEADER_ID = "# Octomap OcTree file"
TREE_DEPTH = 16
TREE_CENTER = 32768  # 2**(TREE_DEPTH-1)
# logodds(0.5): octomap's default occupancy threshold (isNodeOccupied)
OCC_LOG_ODDS_THRESHOLD = 0.0
# octomap's default clamping maximum, logodds(0.971): the writers' leaf value
_CLAMP_MAX_LOG_ODDS = 3.5


@dataclass
class BinaryOcTree:
    resolution: float
    # (K, 3) int64 leaf keys at max depth and per-leaf cube size in voxels
    occupied_keys: np.ndarray  # (K, 3) min-corner key of each occupied leaf cube
    occupied_sizes: np.ndarray  # (K,) cube edge length in voxels (2**(16-depth))
    free_keys: np.ndarray
    free_sizes: np.ndarray

    def occupied_voxel_keys(self) -> np.ndarray:
        """Expand occupied leaves to individual max-depth voxel keys (K', 3)."""
        return _expand(self.occupied_keys, self.occupied_sizes)

    def occupied_centers(self) -> np.ndarray:
        """(K', 3) world coordinates of occupied voxel centers in meters."""
        keys = self.occupied_voxel_keys()
        return (keys.astype(np.float64) - TREE_CENTER + 0.5) * self.resolution


def _expand(keys: np.ndarray, sizes: np.ndarray) -> np.ndarray:
    if len(keys) == 0:
        return np.zeros((0, 3), dtype=np.int64)
    out = []
    for k, s in zip(keys, sizes):
        s = int(s)
        if s == 1:
            out.append(k[None, :])
        else:
            r = np.arange(s)
            gx, gy, gz = np.meshgrid(r, r, r, indexing="ij")
            offs = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=1)
            out.append(k[None, :] + offs)
    return np.concatenate(out, axis=0)


def _open(path_or_bytes):
    if isinstance(path_or_bytes, (bytes, bytearray)):
        return io.BytesIO(path_or_bytes)
    return open(path_or_bytes, "rb")


def read_bt(path_or_bytes) -> BinaryOcTree:
    with _open(path_or_bytes) as stream:
        return _read_stream(stream)


def read_ot(path_or_bytes) -> BinaryOcTree:
    """Read a full-format (.ot, id OcTree) octree — the fullMsgToMap branch
    of node_3d.cpp:270-273."""
    with _open(path_or_bytes) as stream:
        return _read_full_stream(stream)


def read_octree(path_or_bytes) -> BinaryOcTree:
    """Dispatch on the header line: binary .bt or full .ot."""
    with _open(path_or_bytes) as stream:
        head = stream.readline().decode("ascii", "replace").strip()
        stream.seek(0)
        if head == _HEADER_ID:
            return _read_stream(stream)
        if head == _FULL_HEADER_ID:
            return _read_full_stream(stream)
        raise ValueError(f"not an octomap file (header {head!r})")


def _read_header(s, expect_id: str, kind: str) -> float:
    line = s.readline().decode("ascii", "replace").strip()
    if line != expect_id:
        raise ValueError(f"not a {kind} file (header {line!r})")
    resolution = None
    while True:
        line = s.readline().decode("ascii", "replace").strip()
        if line.startswith("#") or line == "":
            continue
        if line.startswith("id "):
            tree_id = line.split(None, 1)[1]
            if kind == ".ot" and tree_id != "OcTree":
                # reference dynamic_casts to octomap::OcTree and asserts
                # (node_3d.cpp:274-278); other tree types are unsupported
                raise ValueError(f"unsupported octree id {tree_id!r}")
            continue
        if line.startswith("size "):
            continue
        if line.startswith("res "):
            resolution = float(line.split()[1])
            continue
        if line == "data":
            break
        raise ValueError(f"unexpected {kind} header line {line!r}")
    if resolution is None:
        raise ValueError(f"{kind} missing resolution")
    return resolution


def _child_offsets(half: int) -> List[np.ndarray]:
    return [np.array([half if (i & 1) else 0, half if (i & 2) else 0,
                      half if (i & 4) else 0], dtype=np.int64) for i in range(8)]


def _pack(items):
    if not items:
        return np.zeros((0, 3), dtype=np.int64), np.zeros((0,), dtype=np.int64)
    keys = np.stack([k for k, _ in items]).astype(np.int64)
    sizes = np.array([s for _, s in items], dtype=np.int64)
    return keys, sizes


def _read_stream(s) -> BinaryOcTree:
    resolution = _read_header(s, _HEADER_ID, ".bt")
    data = s.read()
    occupied: List[Tuple[np.ndarray, int]] = []
    free: List[Tuple[np.ndarray, int]] = []

    # Iterative DFS matching octomap's recursive writeBinaryNode order:
    # read 2 bytes for a node, classify 8 children, recurse inner children
    # in ascending child index.
    pos = 0
    stack = [(np.zeros(3, dtype=np.int64), 0)]  # (min-corner key at max depth, depth)
    while stack:
        key, depth = stack.pop()
        if pos + 2 > len(data):
            raise ValueError("truncated .bt data stream")
        b1, b2 = data[pos], data[pos + 1]
        pos += 2
        half = 1 << (TREE_DEPTH - depth - 1)  # child cube edge in voxels
        offs = _child_offsets(half)
        inner_children = []
        for i in range(8):
            bits = (b1 >> (2 * i)) & 0b11 if i < 4 else (b2 >> (2 * (i - 4))) & 0b11
            if bits == 0b00:
                continue
            child_key = key + offs[i]
            if bits == 0b01:
                occupied.append((child_key, half))
            elif bits == 0b10:
                free.append((child_key, half))
            else:  # 0b11 inner
                inner_children.append((child_key, depth + 1))
        # push in reverse so child 0 is processed first (stream is DFS 0..7)
        stack.extend(reversed(inner_children))

    ok, osz = _pack(occupied)
    fk, fsz = _pack(free)
    return BinaryOcTree(resolution, ok, osz, fk, fsz)


def _read_full_stream(s) -> BinaryOcTree:
    resolution = _read_header(s, _FULL_HEADER_ID, ".ot")
    data = s.read()

    occupied: List[Tuple[np.ndarray, int]] = []
    free: List[Tuple[np.ndarray, int]] = []

    # Iterative DFS matching octomap's writeNodesRecurs order: per node a
    # float32 log-odds value then a child-allocation byte; children 0..7.
    pos = 0
    stack = [(np.zeros(3, dtype=np.int64), 0)]
    while stack:
        key, depth = stack.pop()
        if pos + 5 > len(data):
            raise ValueError("truncated .ot data stream")
        value = np.frombuffer(data, dtype="<f4", count=1, offset=pos)[0]
        mask = data[pos + 4]
        pos += 5
        if mask == 0:  # leaf: classify by log-odds occupancy threshold
            size = 1 << (TREE_DEPTH - depth)
            (occupied if value > OCC_LOG_ODDS_THRESHOLD else free).append((key, size))
            continue
        offs = _child_offsets(1 << (TREE_DEPTH - depth - 1))
        children = [(key + offs[i], depth + 1) for i in range(8) if (mask >> i) & 1]
        stack.extend(reversed(children))

    ok, osz = _pack(occupied)
    fk, fsz = _pack(free)
    return BinaryOcTree(resolution, ok, osz, fk, fsz)


# --- writers -----------------------------------------------------------------


def _center_keys(resolution: float, occupied_centers: np.ndarray) -> np.ndarray:
    """(K, 3) int64 max-depth keys of voxel centers (meters)."""
    centers = np.asarray(occupied_centers, dtype=np.float64).reshape(-1, 3)
    keys = np.floor(centers / resolution).astype(np.int64) + TREE_CENTER
    if np.any((keys < 0) | (keys >= 2 * TREE_CENTER)):
        raise ValueError("voxel outside octree key range")
    return keys


def _morton(keys: np.ndarray) -> np.ndarray:
    """(K,) int64 Morton codes: per level, from the root down, the 3-bit
    child index (z << 2) | (y << 1) | x of the key's bit at that level."""
    code = np.zeros(len(keys), dtype=np.int64)
    for level in range(TREE_DEPTH):
        bit = TREE_DEPTH - 1 - level
        child = (((keys[:, 0] >> bit) & 1) | (((keys[:, 1] >> bit) & 1) << 1)
                 | (((keys[:, 2] >> bit) & 1) << 2))
        code = (code << 3) | child
    return code


def _tree_nodes(keys: np.ndarray):
    """The occupied tree's nodes in depth-first order (children 0..7), each
    as (depth, child mask): a node at depth d is a distinct d-level prefix
    of the keys' Morton codes; the root (depth 0) always exists. Depth-first
    order is the order of the codes padded to full depth, a node before
    its descendants."""
    full = np.unique(_morton(keys))
    prefixes = [np.zeros(1, dtype=np.int64)] + [
        np.unique(full >> (3 * (TREE_DEPTH - d))) for d in range(1, TREE_DEPTH + 1)]
    masks = []
    for d in range(TREE_DEPTH + 1):
        mask = np.zeros(len(prefixes[d]), dtype=np.int64)
        if d < TREE_DEPTH:
            child = prefixes[d + 1]
            parent = np.searchsorted(prefixes[d], child >> 3)
            np.bitwise_or.at(mask, parent, np.int64(1) << (child & 7))
        masks.append(mask)
    depth = np.concatenate([np.full(len(p), d) for d, p in enumerate(prefixes)])
    padded = np.concatenate([p << (3 * (TREE_DEPTH - d)) for d, p in enumerate(prefixes)])
    order = np.lexsort((depth, padded))
    return depth[order], np.concatenate(masks)[order], len(full)


def _write(path, header_id: str, resolution: float, size: int, body: bytes) -> None:
    with open(path, "wb") as f:
        f.write((header_id + "\n").encode())
        f.write(b"# (generated by badger_amcl_tpu)\n")
        f.write(b"id OcTree\n")
        f.write(f"size {size}\n".encode())
        f.write(f"res {resolution}\n".encode())
        f.write(b"data\n")
        f.write(body)


def write_ot(path, resolution: float, occupied_centers: np.ndarray) -> None:
    """Write a full-format (.ot) file containing the given occupied voxel
    centers at clamping-max log-odds, everything else implicit. Inner nodes
    get the max of their children's values (octomap's default pruning value
    is irrelevant here — AMCL only reads leaves). Fixture twin of write_bt."""
    _, mask, size = _tree_nodes(_center_keys(resolution, occupied_centers))
    body = np.empty((len(mask), 5), dtype=np.uint8)
    body[:, :4] = np.frombuffer(np.float32(_CLAMP_MAX_LOG_ODDS).tobytes(), dtype=np.uint8)
    body[:, 4] = mask
    _write(path, _FULL_HEADER_ID, resolution, size, body.tobytes())


def write_bt(path, resolution: float, occupied_centers: np.ndarray) -> None:
    """Write a .bt file containing the given occupied voxel centers (meters).

    All leaves are emitted at max depth (no pruning) — valid, just not
    maximally compact. Free space is not recorded (matches how AMCL uses the
    octree: only occupied leaves matter, octomap.cpp:220-240).
    """
    depth, mask, size = _tree_nodes(_center_keys(resolution, occupied_centers))
    inner = depth < TREE_DEPTH
    depth, mask = depth[inner], mask[inner]
    # two bits per child: 0b01 an occupied leaf (children of depth 15), 0b11
    # an inner child
    code = np.where(depth == TREE_DEPTH - 1, 0b01, 0b11)
    body = np.zeros((len(mask), 2), dtype=np.int64)
    for i in range(8):
        present = (mask >> i) & 1
        body[:, i // 4] |= (present * code) << (2 * (i % 4))
    _write(path, _HEADER_ID, resolution, size, body.astype(np.uint8).tobytes())
