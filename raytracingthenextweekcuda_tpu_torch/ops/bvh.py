"""LBVH construction: Morton sort and a Karras binary radix tree
(counterpart of raytracingthenextweekcuda_tpu/ops/bvh.py).

The topology (child ids, leaf order, each node's leaf range) is built on
the host in vectorized numpy from Morton codes, once per scene, and is
deterministic. The node boxes live in flat (node_lo, node_hi) arrays that
`refit` recomputes in torch from live vertices without rebuilding the
topology (moving geometry, inverse rendering). Boxes carry no gradient:
they only select, as in the reference.

Node ids: [0, T-2] are internal nodes, [T-1, 2T-2] leaves; leaf id i holds
triangle `tri_order[i - (T-1)]`; the root is node 0. The numpy helpers are
the reference's, copied as they are.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from raytracingthenextweekcuda_tpu_torch.ops.intersect import leaf

MORTON_BITS = 10  # 10 bits an axis: 30-bit codes


class BVH(NamedTuple):
    """A binary BVH over single-triangle leaves, as torch tensors."""

    left: torch.Tensor         # (I,) int32 child node id
    right: torch.Tensor        # (I,) int32
    node_lo: torch.Tensor      # (I+T, 3) float32: internal, then leaf boxes
    node_hi: torch.Tensor      # (I+T, 3) float32
    tri_order: torch.Tensor    # (T,) int32: leaf i -> triangle tri_order[i]
    range_first: torch.Tensor  # (I,) int32: sorted-leaf range of the node
    range_last: torch.Tensor   # (I,) int32

    @property
    def num_internal(self) -> int:
        return self.left.shape[0]

    @property
    def num_leaves(self) -> int:
        return self.tri_order.shape[0]

    def to(self, device) -> "BVH":
        return BVH(*(t.to(device) for t in self))


def _expand_bits(v: np.ndarray) -> np.ndarray:
    """Spread 10 bits of v over 30 bits (bit i -> bit 3i)."""
    v = v.astype(np.uint64)
    v = (v * np.uint64(0x00010001)) & np.uint64(0xFF0000FF)
    v = (v * np.uint64(0x00000101)) & np.uint64(0x0F00F00F)
    v = (v * np.uint64(0x00000011)) & np.uint64(0xC30C30C3)
    v = (v * np.uint64(0x00000005)) & np.uint64(0x49249249)
    return v


def morton_codes(centroids: np.ndarray) -> np.ndarray:
    """30-bit Morton codes of points normalized to their AABB."""
    lo = centroids.min(axis=0)
    hi = centroids.max(axis=0)
    extent = np.where(hi - lo > 0, hi - lo, 1.0)
    q = ((centroids - lo) / extent * (2**MORTON_BITS - 1)).astype(np.uint64)
    q = np.minimum(q, 2**MORTON_BITS - 1)
    return (
        (_expand_bits(q[:, 0]) << np.uint64(2))
        | (_expand_bits(q[:, 1]) << np.uint64(1))
        | _expand_bits(q[:, 2])
    )


def _floor_log2(x: np.ndarray) -> np.ndarray:
    """floor(log2(x)) for uint64 x > 0, exact."""
    x = x.astype(np.uint64)
    result = np.zeros(x.shape, np.int64)
    cur = x.copy()
    for s in (32, 16, 8, 4, 2, 1):
        mask = (cur >> np.uint64(s)) != 0
        result[mask] += s
        cur = np.where(mask, cur >> np.uint64(s), cur)
    return result


def _karras_topology(codes: np.ndarray):
    """Vectorized Karras 2012 binary radix tree over strictly increasing
    (T,) uint64 codes: (left, right, range_first, range_last)."""
    T = codes.shape[0]
    I = T - 1

    def delta(i: np.ndarray, j: np.ndarray) -> np.ndarray:
        """Common-prefix length of codes i and j; -1 out of range."""
        out = np.full(i.shape, -1, np.int64)
        ok = (j >= 0) & (j < T)
        ii, jj = i[ok], j[ok]
        x = codes[ii] ^ codes[jj]
        out[ok] = 63 - _floor_log2(np.where(x == 0, 1, x))
        return out

    i = np.arange(I, dtype=np.int64)
    d = np.sign(delta(i, i + 1) - delta(i, i - 1)).astype(np.int64)
    d = np.where(d == 0, 1, d)
    delta_min = delta(i, i - d)

    # Upper bound on the range length: double until the prefix drops.
    lmax = np.full(I, 2, np.int64)
    while True:
        over = delta(i, i + lmax * d) > delta_min
        if not over.any():
            break
        lmax[over] *= 2

    # Binary-search the other end j = i + l*d.
    l = np.zeros(I, np.int64)
    t = lmax // 2
    while (t >= 1).any():
        step = np.where(t >= 1, t, 0)
        cond = (step > 0) & (delta(i, i + (l + step) * d) > delta_min)
        l[cond] += step[cond]
        t //= 2

    j = i + l * d
    delta_node = delta(i, j)

    # Binary-search the split position.
    s = np.zeros(I, np.int64)
    t = l.copy()
    while True:
        t = (t + 1) // 2
        cand = s + t
        cond = (delta(i, i + cand * d) > delta_node) & (cand < l)
        s[cond] = cand[cond]
        if (t <= 1).all():
            break
    gamma = i + s * d + np.minimum(d, 0)

    lo_range = np.minimum(i, j)
    hi_range = np.maximum(i, j)
    # A child is a leaf iff it covers exactly one sorted position.
    left = np.where(lo_range == gamma, gamma + I, gamma)
    right = np.where(hi_range == gamma + 1, gamma + 1 + I, gamma + 1)
    return (left.astype(np.int32), right.astype(np.int32),
            lo_range.astype(np.int32), hi_range.astype(np.int32))


def _fit_boxes_host(left, right, tri_lo, tri_hi):
    """Bottom-up AABB fit: an internal node resolves once both children
    have."""
    T = tri_lo.shape[0]
    I = T - 1
    node_lo = np.empty((I + T, 3), np.float32)
    node_hi = np.empty((I + T, 3), np.float32)
    node_lo[I:] = tri_lo
    node_hi[I:] = tri_hi
    done = np.zeros(I + T, bool)
    done[I:] = True
    pending = np.arange(I)
    while pending.size:
        l, r = left[pending], right[pending]
        ready = done[l] & done[r]
        idx = pending[ready]
        node_lo[idx] = np.minimum(node_lo[left[idx]], node_lo[right[idx]])
        node_hi[idx] = np.maximum(node_hi[left[idx]], node_hi[right[idx]])
        done[idx] = True
        pending = pending[~ready]
    return node_lo, node_hi


def host_vertices(triangles) -> np.ndarray:
    """The triangles' vertices as a detached (T, 3, 3) float32 numpy array."""
    v = triangles.vertices
    if torch.is_tensor(v):
        v = v.detach().cpu().numpy()
    return np.asarray(v, np.float32).reshape(-1, 3, 3)


def build_bvh(triangles, device="cpu") -> BVH:
    """The LBVH of a Triangles batch (numpy or tensor vertices; selection
    only, so tensors are detached), on `device`."""
    vertices = host_vertices(triangles)
    T = vertices.shape[0]
    if T < 2:
        raise ValueError("build_bvh needs >= 2 triangles (use brute force)")
    centroids = vertices.mean(axis=1)
    codes = morton_codes(centroids)
    # Strictly increasing codes: the sorted position in the low 32 bits
    # (ties by original index), Karras' fix for duplicate codes.
    order = np.argsort(codes, kind="stable").astype(np.int64)
    aug = (codes[order] << np.uint64(32)) | np.arange(T, dtype=np.uint64)
    left, right, first, last = _karras_topology(aug)
    node_lo, node_hi = _fit_boxes_host(left, right, vertices.min(axis=1)[order],
                                       vertices.max(axis=1)[order])
    arrays = (left, right, node_lo, node_hi, order.astype(np.int32), first, last)
    return BVH(*(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in arrays))


def refit(bvh: BVH, triangles) -> BVH:
    """The node boxes refit to the current vertices, topology fixed.

    A Karras internal node covers a contiguous range of sorted leaves
    (range_first..range_last), so its box is a range min/max, answered from
    sparse tables of power-of-two windows: O(T log T) torch ops on the
    BVH's device, no host round trip (reference ops/bvh.py:218-261).
    """
    dev = bvh.node_lo.device
    verts = leaf(triangles.vertices, dev).detach().reshape(-1, 3, 3)
    order = bvh.tri_order.long()
    tri_lo = verts.amin(dim=1)[order]
    tri_hi = verts.amax(dim=1)[order]
    T = bvh.num_leaves
    levels = max(1, int(np.floor(np.log2(T))) + 1)
    lo_tabs, hi_tabs = [tri_lo], [tri_hi]
    for k in range(1, levels):
        half = 1 << (k - 1)
        prev_lo, prev_hi = lo_tabs[-1], hi_tabs[-1]
        lo_tabs.append(torch.minimum(prev_lo, torch.cat([prev_lo[half:],
                                                         prev_lo[-half:]])))
        hi_tabs.append(torch.maximum(prev_hi, torch.cat([prev_hi[half:],
                                                         prev_hi[-half:]])))
    lo_tab, hi_tab = torch.stack(lo_tabs), torch.stack(hi_tabs)
    first, last = bvh.range_first.long(), bvh.range_last.long()
    length = last - first + 1
    k = torch.floor(torch.log2(length.double())).long().clamp(0, levels - 1)
    tail = last - (1 << k) + 1
    int_lo = torch.minimum(lo_tab[k, first], lo_tab[k, tail])
    int_hi = torch.maximum(hi_tab[k, first], hi_tab[k, tail])
    return bvh._replace(node_lo=torch.cat([int_lo, tri_lo]),
                        node_hi=torch.cat([int_hi, tri_hi]))


__all__ = ["BVH", "MORTON_BITS", "build_bvh", "host_vertices", "morton_codes",
           "refit"]
