"""Build the package's CUDA sources at first use and load them with ctypes.

`nvcc` compiles every `csrc/*.cu` for sm_90a (Hopper), without fast math
(the kernels must round as their plain torch versions do), one process per
source, all started together; the objects are linked into one shared
library with a plain C interface. The library goes into `_build/` beside
the package (gitignored), named by a hash of the sources and flags, so a
change to a source rebuilds it and an unchanged tree loads the cached
file; nvcc's report of each source is kept beside it. A failed build or
load raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

PACKAGE_DIR = pathlib.Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "--fmad=false",
                 "-Xcompiler", "-fPIC")
LINK_FLAGS = (*ARCH_FLAGS, "-shared")

_LIB: ctypes.CDLL | None = None
# Seconds the last build of this process took (0.0 when the cached library
# was loaded) and what nvcc printed for each source when the library was
# built, including ptxas's register and spill report for each kernel.
BUILD_SECONDS = 0.0
BUILD_LOGS: dict[str, str] = {}


def _nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home:
            candidates.append(os.path.join(home, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _sources() -> list[pathlib.Path]:
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for p in sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"librtnw_kernels-{h.hexdigest()[:16]}.so"


def _run(cmd: list[str]) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    return proc.stdout + proc.stderr


def build() -> pathlib.Path:
    """Compile the sources unless the library for their hash exists."""
    global BUILD_SECONDS
    out = library_path()
    logs_path = out.with_suffix(".logs.json")
    if out.exists():
        BUILD_SECONDS = 0.0
        BUILD_LOGS.clear()
        if logs_path.exists():
            BUILD_LOGS.update(json.loads(logs_path.read_text()))
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = pathlib.Path(tmp) / f"{src.stem}.o"
            cmd = [nvcc, *COMPILE_FLAGS, "-Xptxas", "-v", "-c", "-o", str(obj),
                   str(src)]
            objs.append(obj)
            procs.append((src.name, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = {}, []
        for name, cmd, proc in procs:
            text, _ = proc.communicate()
            logs[name] = text
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{text}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_out = pathlib.Path(tmp) / out.name
        _run([nvcc, *LINK_FLAGS, "-o", str(tmp_out), *map(str, objs)])
        logs_path.write_text(json.dumps(logs))
        os.replace(tmp_out, out)
    BUILD_LOGS.clear()
    BUILD_LOGS.update(logs)
    BUILD_SECONDS = time.perf_counter() - t0
    return out


def load() -> ctypes.CDLL:
    """The kernels' library, built on first call, with argtypes set."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn = lib.rtnw_render_samples  # K1
        fn.argtypes = [
            vp,                      # scene rows (float*)
            ci, ci, ci, ci, ci,      # n_sph, n_pla, n_trih, n_quad, n_box
            vp, vp, vp, vp, vp,      # tile-BVH: bounds, meta, real columns,
            ci, ci,                  # Havel rows and column vectors; nodes,
                                     # Havel columns
            vp,                      # frame (21 floats)
            vp, ci,                  # sample key words (2*S uint32), S
            vp, ci,                  # pixel ids (int32), n
            ci, ci,                  # width, height
            ci, ci, cf, ci,          # bounces, rr_start, tmin, flags
            vp,                      # out (n, 3) float
            vp,                      # cudaStream_t
        ]
        fn.restype = ci
        fn = lib.rtnw_path_trace  # K2
        fn.argtypes = [
            vp,                      # scene rows (float*)
            ci, ci, ci, ci, ci,      # n_sph, n_pla, n_trih, n_quad, n_box
            vp, vp, vp, vp, vp,      # tile-BVH: bounds, meta, real columns,
            ci, ci,                  # Havel rows and column vectors; nodes,
                                     # Havel columns
            vp, vp, vp, vp,          # origin, direction (n, 3), time, pixel ids
            ctypes.c_uint32, ctypes.c_uint32,  # the sample's key words
            ci, ci, ci, cf, ci,      # n, bounces, rr_start, tmin, flags
            vp,                      # out (n, 3) float
            vp,                      # cudaStream_t
        ]
        fn.restype = ci
        fn = lib.rtnw_bounce_step  # K0
        fn.argtypes = [
            vp,                      # scene rows (float*)
            ci, ci, ci, ci, ci,      # n_sph, n_pla, n_trih, n_quad, n_box
            vp, vp, vp, vp, vp,      # tile-BVH: bounds, meta, real columns,
            ci, ci,                  # Havel rows and column vectors; nodes,
                                     # Havel columns
            vp, vp,                  # host arrays of the carry's 13 input
                                     # and 12 output row pointers
            vp, vp,                  # alive (int32), u4 (n, 4)
            ci, ci, cf, ci,          # n, do_rr, tmin, flags
            vp,                      # alive out (int32)
            vp,                      # cudaStream_t
        ]
        fn.restype = ci
        fn = lib.rtnw_closest_hit  # K3
        fn.argtypes = [
            vp, ci, ci, ci,          # rows (float*), n_sph, n_pla, n_tri
            vp, vp, vp, vp, ci,      # origin, direction, time, alive (u8), n
            cf,                      # tmin
            vp, vp,                  # t out (float*), code out (int32*)
            vp,                      # cudaStream_t
        ]
        fn.restype = ci
        fn = lib.rtnw_bvh_winner  # K4
        fn.argtypes = [
            vp, vp, vp, vp,          # origin, direction, alive (u8), tcap
            ci, vp, vp, vp, ci,      # n_blocks, counts, order, entry, n_leaves
            vp, vp, vp,              # root, leaf_bounds, leaf_tiles
            vp, vp, ci,              # leaf_count, aos rows, leaf buffer width
            cf,                      # tmin
            vp, vp,                  # t out (float*), code out (int32*)
            vp,                      # stats out ((n_blocks, 2) int32*) or null
            vp,                      # cudaStream_t
        ]
        fn.restype = ci
        fn = lib.rtnw_worklist  # the exact work-list build
        fn.argtypes = [
            vp, vp, vp, vp,          # origin, direction, alive (u8), tcap
            ci, vp, ci,              # n_blocks, leaf_bounds, n_leaves
            cf,                      # tmin
            vp, vp, vp,              # counts, order (int32*), entry (float*) out
            vp,                      # cudaStream_t
        ]
        fn.restype = ci
        fn = lib.rtnw_shade  # the sorted wavefront's shading
        ll = ctypes.c_longlong
        fn.argtypes = [
            vp, vp, vp,              # origin, direction (n, 3), time
            vp, vp, vp,              # throughput, radiance (n, 3), alive (u8)
            vp, vp, vp, vp,          # K3's t, code; K4's t, code (or null)
            vp, vp, vp, vp, ll, ll,  # slot, pixel table (or null), key words
                                     # (int64*); the slot divisors n, m
            vp, ci, vp, ci, vp, ci,  # spheres (S, 10), planes (P, 7),
                                     # triangles (T, 10) and their counts
            vp, vp, vp, vp,          # materials: kind (int64*), albedo,
                                     # param, emission
            ci, ci, ci,              # n, bounce, flags
            vp, vp, vp, vp, vp,      # origin, direction, throughput,
                                     # radiance, alive out
            vp,                      # cudaStream_t
        ]
        fn.restype = ci
        # CTAs a SM of each kernel at a launch's shared memory.
        ip = ctypes.POINTER(ci)
        fn = lib.rtnw_render_occupancy  # K1, K2, K0
        fn.argtypes = [ci, ci,             # kernel (0 K1, 1 K2, 2 K0), walk
                       ci, ci, ci, ci, ci,  # n_sph, n_pla, n_trih, n_quad, n_box
                       ip, ip]             # CTAs a SM, threads a CTA (out)
        fn.restype = ci
        fn = lib.rtnw_closest_hit_occupancy  # K3
        fn.argtypes = [ci, ci, ci, ip, ip]  # n_sph, n_pla, n_tri; CTAs, threads
        fn.restype = ci
        fn = lib.rtnw_bvh_winner_occupancy  # K4
        fn.argtypes = [ci, ip, ip]          # leaf buffer width; CTAs, threads
        fn.restype = ci
        fn = lib.rtnw_worklist_occupancy  # the work-list build
        fn.argtypes = [ci, ip, ip]          # n_leaves; CTAs, threads
        fn.restype = ci
        fn = lib.rtnw_shade_occupancy  # the shade kernel
        fn.argtypes = [ip, ip]              # CTAs, threads
        fn.restype = ci
        lib.rtnw_error_string.argtypes = [ci]
        lib.rtnw_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def occupancy(query: str, *args: int) -> tuple[int, int]:
    """(CTAs resident on one SM, threads a CTA) of a kernel at a launch's
    shared memory, from its query in the library: `rtnw_render_occupancy`
    (K1, K2 or K0), `rtnw_closest_hit_occupancy` (K3),
    `rtnw_bvh_winner_occupancy` (K4), `rtnw_worklist_occupancy` (the
    work-list build) or `rtnw_shade_occupancy` (the shade kernel), with
    that launch's size arguments."""
    ctas, threads = ctypes.c_int(0), ctypes.c_int(0)
    err = getattr(load(), query)(*args, ctypes.byref(ctas), ctypes.byref(threads))
    if err != 0:
        raise RuntimeError(f"{query} failed: {load().rtnw_error_string(err).decode()}")
    return ctas.value, threads.value
