"""The work the kernels' plain versions did, for the kernels' bounds.

The plain versions of K1, K2 and K0 (ops/cuda/bounce_kernel.py) and of K4
(ops/cuda/bvh_winner_kernel.py) add to WORK the work their inputs need:
live path-bounces, the rays' box tests of tile-BVH nodes or leaves, their
ray-leaf visits and the triangle tests of those visits. A leaf's triangles
are the columns of its tile with a nonzero normal: the zero padding of a
tile can never be hit and is not counted. K4's plain version also counts
the (block, leaf) pairs it evaluates, `block_leaves`: leaf_visits over it
is the mean number of rays of a block that need a leaf it scans.
chip_smoke.py sets the counts to zero with `reset`, runs a plain version
and turns them into the kernel's bound.
"""

from __future__ import annotations

import torch

WORK = {"bounces": 0, "box_tests": 0, "leaf_visits": 0, "triangle_tests": 0,
        "block_leaves": 0}


def reset() -> None:
    """Set every count of WORK to zero."""
    WORK.update(dict.fromkeys(WORK, 0))


def tile_triangles(normals: torch.Tensor, first: torch.Tensor,
                   width: int) -> torch.Tensor:
    """(C,) the triangles of the leaf tiles of `width` columns that start at
    the columns `first` (C,) of the Havel normal rows `normals` (3, columns)."""
    cols = first.to(torch.int64)[:, None] + torch.arange(width, device=first.device)
    return (normals[:, cols] != 0).any(dim=0).sum(dim=1)


def count_leaves(rays: torch.Tensor, triangles: torch.Tensor) -> None:
    """Add leaf visits to WORK: `rays` (C,) the rays that enter each
    visited leaf, `triangles` (C,) the leaf's triangles (`tile_triangles`)."""
    WORK["leaf_visits"] += int(rays.sum())
    WORK["triangle_tests"] += int((rays.to(torch.int64) * triangles).sum())


__all__ = ["WORK", "count_leaves", "reset", "tile_triangles"]
