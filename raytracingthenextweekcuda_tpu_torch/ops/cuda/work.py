"""The work the kernels' plain versions did, for the kernels' bounds.

The plain versions of K1, K2 and K0 (ops/cuda/bounce_kernel.py) and of K4
(ops/cuda/bvh_winner_kernel.py) add to WORK the work their inputs need:
live path-bounces, the rays' box tests of tile-BVH nodes or leaves, their
ray-leaf visits and the triangle tests of those visits. A leaf's triangles
are the columns of its tile with a nonzero normal: the zero padding of a
tile can never be hit and is not counted. K4's plain version also counts
the (block, leaf) pairs it evaluates, `block_leaves`: leaf_visits over it
is the mean number of rays of a block that need a leaf it scans. It also
counts what K4's chunk cull leaves: `chunk_tests`, the listed rays' tests
of their leaves' 32-column chunk boxes, and `chunk_triangle_tests`, the
real triangles of the chunks they enter, so that chunk_triangle_tests /
triangle_tests is the share of the leaves' triangles K4 tests; and
`chunk_misses`, the hits below a ray's best in chunks it does not enter,
which must stay 0: the cull is sound where it leaves out no candidate.
The packet-frustum work-list pass counts the (block, leaf) pairs it
tests, `frustum_pairs`, from the shapes alone (no device read). The work-list
kernel's plain version counts what the kernel's group cull leaves:
`group_tests`, the live rays' tests of the boxes of 32-leaf groups;
`group_leaf_tests`, the leaves of the groups they enter, so that
group_leaf_tests / (live rays x leaves) is the share of slab tests the cull
keeps; and `group_misses`, the leaf hits of rays that miss the leaf's group,
which must stay 0.
chip_smoke.py sets the counts to zero with `reset`, runs a plain version
and turns them into the kernel's bound.
"""

from __future__ import annotations

import torch

from raytracingthenextweekcuda_tpu_torch.ops.bvh_tile import CHUNK

WORK = {"bounces": 0, "box_tests": 0, "leaf_visits": 0, "triangle_tests": 0,
        "block_leaves": 0, "chunk_tests": 0, "chunk_triangle_tests": 0,
        "chunk_misses": 0, "frustum_pairs": 0, "group_tests": 0,
        "group_leaf_tests": 0, "group_misses": 0}


def reset() -> None:
    """Set every count of WORK to zero."""
    WORK.update(dict.fromkeys(WORK, 0))


def tile_triangles(normals: torch.Tensor, first: torch.Tensor,
                   width: int) -> torch.Tensor:
    """(C,) the triangles of the leaf tiles of `width` columns that start at
    the columns `first` (C,) of the Havel normal rows `normals` (3, columns)."""
    cols = first.to(torch.int64)[:, None] + torch.arange(width, device=first.device)
    return (normals[:, cols] != 0).any(dim=0).sum(dim=1)


def chunk_triangles(normals: torch.Tensor, first: torch.Tensor, width: int,
                    n_chunks: int) -> torch.Tensor:
    """(C, n_chunks) the triangles of each run of CHUNK columns of the
    leaf tiles of `width` columns that start at the columns `first` (C,)."""
    lanes = torch.arange(n_chunks * CHUNK, device=first.device)
    cols = first.to(torch.int64)[:, None] + lanes.clamp_max(width - 1)
    real = (normals[:, cols] != 0).any(dim=0) & (lanes < width)
    return real.view(-1, n_chunks, CHUNK).sum(dim=2)


def count_leaves(rays: torch.Tensor, triangles: torch.Tensor) -> None:
    """Add leaf visits to WORK: `rays` (C,) the rays that enter each
    visited leaf, `triangles` (C,) the leaf's triangles (`tile_triangles`)."""
    WORK["leaf_visits"] += int(rays.sum())
    WORK["triangle_tests"] += int((rays.to(torch.int64) * triangles).sum())


def count_groups(tests: int, enters: torch.Tensor, group_size: torch.Tensor,
                 misses: torch.Tensor) -> None:
    """Add the work-list group cull to WORK: `tests` group-box tests,
    `enters` (rays, G) the groups each ray enters, `group_size` (G,) their
    leaves, `misses` (rays, L) the leaf hits outside an entered group."""
    WORK["group_tests"] += tests
    WORK["group_leaf_tests"] += int((enters.to(torch.int64) * group_size).sum())
    WORK["group_misses"] += int(misses.sum())


__all__ = ["WORK", "chunk_triangles", "count_groups", "count_leaves", "reset",
           "tile_triangles"]
