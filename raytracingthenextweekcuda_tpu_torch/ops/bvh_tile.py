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


def permute_rows(rows: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """Reorder per-triangle planar rows (R, T) into leaf-tile order
    (R, n_leaves * leaf_size), zero-filling padded slots."""
    out = np.zeros((rows.shape[0], perm.shape[0]), rows.dtype)
    valid = perm >= 0
    out[:, valid] = np.asarray(rows)[:, perm[valid]]
    return out


__all__ = ["TileBVH", "build_tile_bvh", "build_tile_bvh_sah",
           "permute_rows", "LEAF_SIZE"]
