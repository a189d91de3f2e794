"""ctypes bindings of the native binned-SAH BVH builder and mesh loaders
(counterpart of raytracingthenextweekcuda_tpu/native.py).

The SAH tree has the LBVH's layout (ops/bvh.py), so `SAHTree.to_bvh` hands
it to the LBVH walk (ops/traverse.py), and the tile-BVH derives its leaves
from it (ops/bvh_tile.py). The loaders (`load_obj_native`,
`load_ply_native`) parse and transform a mesh file as io/obj.py and
io/ply.py do, and also read binary little-endian PLY.

The shared library is the repository's `native/build/lib/librtnw_native.so`
(built from native/bvh_builder.cpp with
`cmake -S native -B native/build -G Ninja && ninja -C native/build`).
When it is absent, `available()` is False and the tile-BVH uses the numpy
median split instead (io/bvh_cache.py), as the reference does; a library
without the loaders' symbols leaves `loaders_available()` False, and the
Python parsers load meshes.
"""

from __future__ import annotations

import ctypes
import pathlib
from typing import NamedTuple

import numpy as np

_ROOT = pathlib.Path(__file__).resolve().parents[1]
_SEARCH = [_ROOT / "native" / "build" / "lib", _ROOT / "native" / "build"]
_LIB: ctypes.CDLL | None = None


class SAHTree(NamedTuple):
    """Per-triangle binary SAH tree: internal nodes 0..T-2 (`left`,
    `right`, contiguous triangle ranges), leaves T-1..2T-2 (leaf k holds
    triangle tri_order[k]); node boxes for all 2T-1 nodes."""

    left: np.ndarray         # (T-1,) i32
    right: np.ndarray        # (T-1,) i32
    node_lo: np.ndarray      # (2T-1, 3) f32
    node_hi: np.ndarray      # (2T-1, 3) f32
    tri_order: np.ndarray    # (T,) i32
    range_first: np.ndarray  # (T-1,) i32
    range_last: np.ndarray   # (T-1,) i32

    def to_bvh(self, device="cpu"):
        """The tree as an ops/bvh.BVH on `device`, for ops/traverse.py."""
        import torch

        from raytracingthenextweekcuda_tpu_torch.ops.bvh import BVH

        return BVH(*(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                     for a in self))


def _load() -> ctypes.CDLL | None:
    global _LIB
    if _LIB is None:
        for d in _SEARCH:
            path = d / "librtnw_native.so"
            if path.exists():
                lib = ctypes.CDLL(str(path))
                fp = ctypes.POINTER(ctypes.c_float)
                ip = ctypes.POINTER(ctypes.c_int32)
                lib.rtnw_build_sah_bvh.restype = ctypes.c_int32
                lib.rtnw_build_sah_bvh.argtypes = [
                    fp, ctypes.c_int32, ip, ip, fp, fp, ip, ip, ip]
                if hasattr(lib, "rtnw_load_mesh"):  # an older library has none
                    lib.rtnw_load_mesh.restype = ctypes.c_int64
                    lib.rtnw_load_mesh.argtypes = [
                        ctypes.c_char_p, ctypes.c_int32, fp, ctypes.c_float, fp,
                        ctypes.c_int32, ctypes.c_float, ip]
                    lib.rtnw_mesh_read.restype = ctypes.c_int32
                    lib.rtnw_mesh_read.argtypes = [ctypes.c_int64, fp]
                    lib.rtnw_last_error.restype = ctypes.c_char_p
                _LIB = lib
                break
    return _LIB


def available() -> bool:
    return _load() is not None


def build_sah_bvh(vertices: np.ndarray) -> SAHTree:
    """Native binned-SAH build over (T, 3, 3) float32 vertices, T >= 2.
    Raises RuntimeError if the library is absent or the build fails."""
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "librtnw_native.so not built; run: "
            "cmake -S native -B native/build -G Ninja && ninja -C native/build")
    verts = np.ascontiguousarray(np.asarray(vertices, np.float32))
    t = verts.shape[0]
    if t < 2:
        raise ValueError("need >= 2 triangles")
    tree = SAHTree(
        left=np.empty(t - 1, np.int32), right=np.empty(t - 1, np.int32),
        node_lo=np.empty((2 * t - 1, 3), np.float32),
        node_hi=np.empty((2 * t - 1, 3), np.float32),
        tri_order=np.empty(t, np.int32),
        range_first=np.empty(t - 1, np.int32),
        range_last=np.empty(t - 1, np.int32),
    )

    def fp(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    def ip(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    depth = lib.rtnw_build_sah_bvh(
        fp(verts), t, ip(tree.left), ip(tree.right), fp(tree.node_lo),
        fp(tree.node_hi), ip(tree.tri_order), ip(tree.range_first),
        ip(tree.range_last))
    if depth <= 0:
        raise RuntimeError(f"native SAH build failed (code {depth})")
    return tree


def loaders_available() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "rtnw_load_mesh")


def _load_mesh(path: str, kind: int, scale, rotate_y: float, offset,
               normalize: bool, max_coord: float) -> np.ndarray:
    """Native mesh parse and transform -> (T, 3, 3) float32 triangles: the
    counterpart of io/obj.load_obj (kind 0) and io/ply.load_ply (kind 1),
    the same transforms, and binary little-endian PLY too."""
    lib = _load()
    if lib is None or not hasattr(lib, "rtnw_load_mesh"):
        raise RuntimeError(
            "librtnw_native.so not built (or without the loaders); run: "
            "cmake -S native -B native/build -G Ninja && ninja -C native/build")
    sc = np.asarray(scale, np.float32).reshape(3)
    off = np.asarray(offset, np.float32).reshape(3)
    count = ctypes.c_int32(0)

    def fp(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    handle = lib.rtnw_load_mesh(
        str(path).encode(), kind, fp(sc), float(rotate_y), fp(off),
        1 if normalize else 0, float(max_coord), ctypes.byref(count))
    if handle < 0:
        raise ValueError(f"{path}: {lib.rtnw_last_error().decode(errors='replace')}")
    tris = np.empty((count.value, 3, 3), np.float32)
    if lib.rtnw_mesh_read(handle, fp(tris)) != 0:
        raise RuntimeError(lib.rtnw_last_error().decode(errors="replace"))
    return tris


def load_obj_native(path: str, scale=(1.0, 1.0, 1.0), rotate=(0.0, 0.0, 0.0),
                    offset=(0.0, 0.0, 0.0)) -> np.ndarray:
    """Native OBJ load: v *= scale; rotateY(v); v += offset
    (ModelLoader.cpp:438-445; only rotate.y is used, as in the reference)."""
    rot_y = float(np.asarray(rotate, np.float32).reshape(3)[1])
    return _load_mesh(path, 0, scale, rot_y, offset, False, 1.0)


def load_ply_native(path: str, offset=(0.0, 0.0, 0.0), normalize: bool = True,
                    max_coord: float = 1.0) -> np.ndarray:
    """Native PLY load (ascii or binary_little_endian) with the reference's
    center/unit-scale/offset normalization (Loader.cpp:104-150)."""
    return _load_mesh(path, 1, (1.0, 1.0, 1.0), 0.0, offset, normalize, max_coord)


__all__ = ["SAHTree", "available", "build_sah_bvh", "load_obj_native",
           "load_ply_native", "loaders_available"]
