"""Tile-BVH: leaf tiles of triangles for the work-list winner kernel K4
(counterpart of raytracingthenextweekcuda_tpu/ops/bvh_tile.py).

A DFS skip-pointer BVH whose leaves are fixed-width tiles of triangles,
stored contiguously in leaf order, so one leaf visit is one scan over one
tile of Havel rows. Two builders give the same layout: a numpy binned
median split over the longest centroid axis, and a walk of the native
binned-SAH tree (native.py) that cuts a leaf at the first subtree of at
most `leaf_size` triangles. Host-only numpy, run once at finalize.
"""

from __future__ import annotations

import sys
from typing import NamedTuple

import numpy as np

LEAF_SIZE = 128


class TileBVH(NamedTuple):
    """DFS skip-pointer BVH with fixed-width leaf tiles."""

    bounds: np.ndarray  # (6, M) f32: lo_x lo_y lo_z hi_x hi_y hi_z
    meta: np.ndarray    # (3, M) i32: is_leaf, leaf tile start, skip node
    # perm[i] = original triangle filling padded slot i, -1 for padding.
    perm: np.ndarray    # (n_leaves * leaf_size,) i32

    @property
    def n_nodes(self) -> int:
        return self.bounds.shape[1]

    @property
    def padded_tri_count(self) -> int:
        return self.perm.shape[0]


def build_tile_bvh(vertices: np.ndarray, leaf_size: int = LEAF_SIZE) -> TileBVH:
    """Median-split TileBVH of (T, 3, 3) float32 triangle vertices."""
    v = np.asarray(vertices, np.float32)
    T = v.shape[0]
    lo_t = v.min(axis=1)
    hi_t = v.max(axis=1)
    centroid = 0.5 * (lo_t + hi_t)

    bounds_list: list[np.ndarray] = []
    meta_list: list[list[int]] = []
    chunks: list[np.ndarray] = []

    def rec(idx: np.ndarray) -> int:
        """Emit the subtree over triangle indices `idx`; return its size."""
        node_id = len(meta_list)
        lo = lo_t[idx].min(axis=0)
        hi = hi_t[idx].max(axis=0)
        bounds_list.append(np.concatenate([lo, hi]))
        meta_list.append([0, 0, 0])
        if idx.size <= leaf_size:
            tile_start = len(chunks) * leaf_size
            chunk = np.full((leaf_size,), -1, np.int32)
            chunk[: idx.size] = idx
            chunks.append(chunk)
            meta_list[node_id] = [1, tile_start, 0]
            return 1
        c = centroid[idx]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        order = np.argsort(c[:, axis], kind="stable")
        half = idx.size // 2
        size = 1 + rec(idx[order[:half]])
        size += rec(idx[order[half:]])
        meta_list[node_id] = [0, 0, 0, size]  # subtree size, read below
        return size

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(
        max(old_limit, 64 + 2 * int(np.ceil(np.log2(max(T, 2)))) * 64))
    try:
        total = rec(np.arange(T, dtype=np.int64))
    finally:
        sys.setrecursionlimit(old_limit)

    M = len(meta_list)
    if total != M:
        raise RuntimeError(f"tile-BVH emitted {M} nodes for a tree of {total}")
    bounds = np.stack(bounds_list, axis=1).astype(np.float32)
    meta = np.zeros((3, M), np.int32)
    for i, m in enumerate(meta_list):  # skip = node id + subtree size
        meta[0, i] = m[0]
        meta[1, i] = m[1]
        meta[2, i] = i + (1 if m[0] else m[3])
    perm = (np.concatenate(chunks).astype(np.int32)
            if chunks else np.full((leaf_size,), -1, np.int32))
    return TileBVH(bounds=bounds, meta=meta, perm=perm)


def build_tile_bvh_sah(vertices: np.ndarray,
                       leaf_size: int = LEAF_SIZE) -> TileBVH:
    """TileBVH whose leaves follow the native binned-SAH tree: walk it
    top-down and cut a leaf at the first subtree of at most `leaf_size`
    triangles. Raises RuntimeError when the native library is absent."""
    from raytracingthenextweekcuda_tpu_torch import native

    b = native.build_sah_bvh(vertices)
    i_n = b.left.shape[0]  # internal nodes; leaf k is node i_n + k

    bounds_list: list[np.ndarray] = []
    meta_list: list[list[int]] = []  # [is_leaf, tile_start, skip]
    chunks: list[np.ndarray] = []

    # Iterative preorder with finish markers (no Python recursion).
    stack: list[tuple[str, int]] = [("visit", 0)]
    while stack:
        op, x = stack.pop()
        if op == "finish":
            meta_list[x][2] = len(meta_list)
            continue
        node_id = len(meta_list)
        bounds_list.append(
            np.concatenate([b.node_lo[x], b.node_hi[x]]).astype(np.float32))
        if x >= i_n:
            first = last = x - i_n
        else:
            first, last = int(b.range_first[x]), int(b.range_last[x])
        count = last - first + 1
        if count <= leaf_size:
            tile_start = len(chunks) * leaf_size
            chunk = np.full((leaf_size,), -1, np.int32)
            chunk[:count] = b.tri_order[first: last + 1]
            chunks.append(chunk)
            meta_list.append([1, tile_start, node_id + 1])
        else:
            meta_list.append([0, 0, 0])
            stack.append(("finish", node_id))
            stack.append(("visit", int(b.right[x])))
            stack.append(("visit", int(b.left[x])))

    bounds = np.stack(bounds_list, axis=1).astype(np.float32)
    meta = np.asarray(meta_list, np.int32).T.copy()
    perm = (np.concatenate(chunks).astype(np.int32)
            if chunks else np.full((leaf_size,), -1, np.int32))
    return TileBVH(bounds=bounds, meta=meta, perm=perm)


# Columns of a chunk: the part of a leaf tile one warp of K4 tests at once.
CHUNK = 32
# The widening of a chunk box: this share of its largest coordinate, for
# the rounding of the Havel test, whose hit points lie within a few ulps of
# those coordinates outside the triangle it accepts.
CHUNK_PAD = 2.0 ** -15


def chunk_bounds(vertices: np.ndarray, havel: np.ndarray,
                 leaf_size: int) -> np.ndarray:
    """(L, 6, ceil(leaf_size / CHUNK)) float32: the box of each run of
    CHUNK columns of each leaf tile, rows lo_x lo_y lo_z hi_x hi_y hi_z.

    `vertices` (L * leaf_size, 3, 3) are the triangles in tile order and
    `havel` (12, L * leaf_size) their Havel rows n(3) dc e1p(3) d1 e2p(3)
    d2. A box holds the vertices of its chunk's real columns (nonzero
    normal) and the corners of the triangles that the rows themselves
    accept (u, v in {(0, 0), (1, 0), (0, 1)} on the plane, in float64), is
    widened by CHUNK_PAD of its largest coordinate and rounded outward. A
    chunk without a real column gets lo = hi = +inf, a box no ray enters.
    """
    T = vertices.shape[0]
    L = T // leaf_size
    C = -(-leaf_size // CHUNK)
    h = np.asarray(havel, np.float64)
    real = (h[0:3] != 0).any(axis=0)
    lo = np.full((T, 3), np.inf)
    hi = np.full((T, 3), -np.inf)
    if real.any():
        # Rows n, e1p, e2p times a corner = dc, u - d1, v - d2.
        m = np.stack([h[0:3].T, h[4:7].T, h[8:11].T], axis=1)[real]
        uv = np.array([[0, 0, 0], [0, 1, 0], [0, 0, 1]], np.float64)
        rhs = np.stack([h[3], -h[7], -h[11]], axis=1)[real][:, :, None] + uv
        corners = np.linalg.solve(m, rhs).transpose(0, 2, 1)  # (R, corner, xyz)
        pts = np.concatenate([np.asarray(vertices, np.float64)[real], corners],
                             axis=1)
        lo[real], hi[real] = pts.min(axis=1), pts.max(axis=1)
    pad_cols = C * CHUNK - leaf_size
    lo = np.pad(lo.reshape(L, leaf_size, 3), ((0, 0), (0, pad_cols), (0, 0)),
                constant_values=np.inf).reshape(L, C, CHUNK, 3).min(axis=2)
    hi = np.pad(hi.reshape(L, leaf_size, 3), ((0, 0), (0, pad_cols), (0, 0)),
                constant_values=-np.inf).reshape(L, C, CHUNK, 3).max(axis=2)
    empty = ~np.isfinite(lo).all(axis=2)
    scale = np.maximum(np.abs(lo), np.abs(hi))
    pad = CHUNK_PAD * np.where(empty, 0.0, scale.max(axis=2))[..., None]
    lo32 = np.nextafter((lo - pad).astype(np.float32), np.float32(-np.inf))
    hi32 = np.nextafter((hi + pad).astype(np.float32), np.float32(np.inf))
    lo32[empty] = hi32[empty] = np.inf
    return np.concatenate([lo32, hi32], axis=2).transpose(0, 2, 1).copy()


def permute_rows(rows: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """Reorder per-triangle planar rows (R, T) into leaf-tile order
    (R, n_leaves * leaf_size), zero-filling padded slots."""
    out = np.zeros((rows.shape[0], perm.shape[0]), rows.dtype)
    valid = perm >= 0
    out[:, valid] = np.asarray(rows)[:, perm[valid]]
    return out


__all__ = ["CHUNK", "TileBVH", "build_tile_bvh", "build_tile_bvh_sah",
           "chunk_bounds", "permute_rows", "LEAF_SIZE"]
