"""LBVH and tile-BVH builds with an optional on-disk cache (counterpart of
raytracingthenextweekcuda_tpu/io/bvh_cache.py).

The cache is an .npz per mesh, keyed by a content hash of the vertex
array: an LBVH (ops/bvh.py) next to the mesh file the caller names
(`build_or_load`), a tile-BVH under a directory the caller names, keyed by
the builder too (`build_or_load_tile_bvh`). Without a path nothing is read
or written.
"""

from __future__ import annotations

import hashlib
import os
import zipfile

import numpy as np
import torch

from raytracingthenextweekcuda_tpu_torch import native
from raytracingthenextweekcuda_tpu_torch.ops.bvh import BVH, build_bvh, host_vertices
from raytracingthenextweekcuda_tpu_torch.ops.bvh_tile import (
    TileBVH,
    build_tile_bvh,
    build_tile_bvh_sah,
)


def mesh_hash(vertices) -> str:
    arr = np.ascontiguousarray(np.asarray(vertices, np.float32))
    return hashlib.sha256(arr.tobytes()).hexdigest()[:16]


def cache_path_for(mesh_path: str, vertices) -> str:
    return f"{mesh_path}.{mesh_hash(vertices)}.bvh.npz"


def save_bvh(path: str, bvh: BVH) -> None:
    np.savez_compressed(path, **{name: t.detach().cpu().numpy()
                                 for name, t in zip(BVH._fields, bvh)})


def load_bvh(path: str, device="cpu") -> BVH:
    with np.load(path) as z:
        return BVH(*(torch.from_numpy(z[name]).to(device) for name in BVH._fields))


def build_or_load(triangles, mesh_path: str | None = None, device="cpu") -> BVH:
    """The LBVH of `triangles` on `device`. With `mesh_path`, a cached
    build of the same vertices next to it is loaded, and a new build is
    stored there."""
    if mesh_path is None:
        return build_bvh(triangles, device)
    path = cache_path_for(mesh_path, host_vertices(triangles))
    if os.path.exists(path):
        try:
            return load_bvh(path, device)
        except (OSError, ValueError, KeyError, zipfile.BadZipFile):
            pass  # unreadable cache file: build anew and overwrite it
    bvh = build_bvh(triangles, device)
    try:
        save_bvh(path, bvh)
    except OSError:
        pass  # the mesh's directory is read-only: the build is not cached
    return bvh


def builder_name() -> str:
    """The builder `build_or_load_tile_bvh` uses here: "sah" when the
    native library loads, else "median"."""
    return "sah" if native.available() else "median"


def save_tile_bvh(path: str, tb: TileBVH) -> None:
    np.savez_compressed(path, bounds=tb.bounds, meta=tb.meta, perm=tb.perm)


def load_tile_bvh(path: str) -> TileBVH:
    with np.load(path) as z:
        return TileBVH(bounds=z["bounds"], meta=z["meta"], perm=z["perm"])


def build_or_load_tile_bvh(vertices: np.ndarray, leaf_size: int,
                           cache_dir: str | None = None) -> TileBVH:
    """TileBVH of `vertices`: the native SAH tiles when the library loads,
    else the median split. With `cache_dir`, a cached build of the same
    vertices and builder is loaded, and a new build is stored there."""
    tag = builder_name()
    path = None
    if cache_dir is not None:
        path = os.path.join(
            cache_dir, f"tile_{tag}{leaf_size}_{mesh_hash(vertices)}.npz")
        if os.path.exists(path):
            try:
                return load_tile_bvh(path)
            except (OSError, ValueError, KeyError, zipfile.BadZipFile):
                pass  # unreadable cache file: build anew and overwrite it
    tb = (build_tile_bvh_sah(vertices, leaf_size) if tag == "sah"
          else build_tile_bvh(vertices, leaf_size))
    if path is not None:
        try:
            os.makedirs(cache_dir, exist_ok=True)
            save_tile_bvh(path, tb)
        except OSError:
            pass  # the cache directory cannot be written: the build is not cached
    return tb


__all__ = ["build_or_load", "build_or_load_tile_bvh", "builder_name",
           "cache_path_for", "load_bvh", "load_tile_bvh", "mesh_hash", "save_bvh",
           "save_tile_bvh"]
