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

_vp, _ci, _cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_u32, _ll, _ip = ctypes.c_uint32, ctypes.c_longlong, ctypes.POINTER(ctypes.c_int)

# The scene arguments that K1, K2 and K0 begin with: the flat rows
# (float*); n_sph, n_pla, n_trih, n_quad, n_box; the tile-BVH's node
# bounds, meta, real columns, Havel rows and their column vectors (null
# without one); the node and Havel column counts.
_SCENE = (_vp, _ci, _ci, _ci, _ci, _ci, _vp, _vp, _vp, _vp, _vp, _ci, _ci)

# The library's C entries, each returning a cudaError_t as int (0 on
# success), with their parameters in order: the launches, each ending in
# its cudaStream_t, and each kernel's occupancy query. `rtnw_error_string`
# (int -> const char*) is set apart in `load`. tests/test_torch_launch.py
# holds this table to the `extern "C"` lines of csrc/*.cu.
SIGNATURES: dict[str, tuple] = {
    "rtnw_render_samples": (  # K1
        *_SCENE,
        _vp,                      # frame (21 floats)
        _vp, _ci,                 # sample key words (2*S uint32), S
        _vp, _ci,                 # pixel ids (int32), n
        _ci, _ci,                 # width, height
        _ci, _ci, _cf, _ci,       # bounces, rr_start, tmin, flags
        _vp,                      # out (n, 3) float
        _vp,                      # cudaStream_t
    ),
    "rtnw_path_trace": (  # K2
        *_SCENE,
        _vp, _vp, _vp, _vp,       # origin, direction (n, 3), time, pixel ids
        _u32, _u32,               # the sample's key words
        _ci, _ci, _ci, _cf, _ci,  # n, bounces, rr_start, tmin, flags
        _vp,                      # out (n, 3) float
        _vp,                      # cudaStream_t
    ),
    "rtnw_bounce_step": (  # K0
        *_SCENE,
        _vp, _vp,                 # host arrays of the carry's 13 input
                                  # and 12 output row pointers
        _vp, _vp,                 # alive (int32), u4 (n, 4)
        _ci, _ci, _cf, _ci,       # n, do_rr, tmin, flags
        _vp,                      # alive out (int32)
        _vp,                      # cudaStream_t
    ),
    "rtnw_closest_hit": (  # K3
        _vp, _ci, _ci, _ci,       # rows (float*), n_sph, n_pla, n_tri
        _vp, _vp, _vp, _vp, _ci,  # origin, direction, time, alive (u8), n
        _cf,                      # tmin
        _vp, _vp,                 # t out (float*), code out (int32*)
        _vp,                      # cudaStream_t
    ),
    "rtnw_bvh_winner": (  # K4
        _vp, _vp, _vp, _vp,       # origin, direction, alive (u8), tcap
        _ci, _vp, _vp, _vp, _ci,  # n_blocks, counts, order, entry, n_leaves
        _vp, _vp, _vp,            # root, leaf_bounds, leaf_tiles
        _vp, _vp,                 # leaf_count, aos rows
        _vp, _ci,                 # chunk_bounds (n_leaves, 6, n_chunks), n_chunks
        _cf,                      # tmin
        _vp, _vp,                 # t out (float*), code out (int32*)
        _vp,                      # stats out ((n_blocks, 2) int32*) or null
        _vp,                      # cudaStream_t
    ),
    "rtnw_worklist": (  # the exact work-list build
        _vp, _vp, _vp, _vp,       # origin, direction, alive (u8), tcap
        _ci, _vp, _ci,            # n_blocks, leaf_bounds, n_leaves
        _vp,                      # group_bounds (6, ceil(n_leaves / 32))
        _cf,                      # tmin
        _vp, _vp, _vp,            # counts, order (int32*), entry (float*) out
        _vp,                      # cudaStream_t
    ),
    "rtnw_shade": (  # the sorted wavefront's shading
        _vp, _vp, _vp,            # origin, direction (n, 3), time
        _vp, _vp, _vp,            # throughput, radiance (n, 3), alive (u8)
        _vp, _vp, _vp, _vp,       # K3's t, code; K4's t, code (or null)
        _vp, _vp, _vp, _vp, _ll, _ll,  # slot, pixel table (or null), key
                                  # words (int64*); the slot divisors n, m
        _vp, _ci, _vp, _ci, _vp, _ci,  # spheres (S, 10), planes (P, 7),
                                  # triangles (T, 10) and their counts
        _vp, _vp, _vp, _vp,       # materials: kind (int64*), albedo,
                                  # param, emission
        _ci, _ci, _ci,            # n, bounce, flags
        _vp, _vp, _vp, _vp, _vp,  # origin, direction, throughput,
                                  # radiance, alive out
        _vp,                      # cudaStream_t
    ),
    # Each kernel's CTAs a SM at a launch's shared memory; the last two
    # parameters are the outputs, CTAs a SM and threads a CTA.
    "rtnw_render_occupancy": (
        _ci, _ci,                 # kernel (0 K1, 1 K2, 2 K0), walk
        _ci, _ci, _ci, _ci, _ci,  # n_sph, n_pla, n_trih, n_quad, n_box
        _ip, _ip,
    ),
    "rtnw_closest_hit_occupancy": (_ci, _ci, _ci, _ip, _ip),  # K3: n_sph, n_pla, n_tri
    "rtnw_bvh_winner_occupancy": (_ip, _ip),       # K4
    "rtnw_worklist_occupancy": (_ci, _ip, _ip),    # the work list: n_leaves
    "rtnw_shade_occupancy": (_ip, _ip),            # the shade kernel
}

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
    """The kernels' library, built on first call, with each entry's
    argtypes from SIGNATURES."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        lib.rtnw_error_string.argtypes = [ctypes.c_int]
        lib.rtnw_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def occupancy(query: str, *args: int) -> tuple[int, int]:
    """(CTAs resident on one SM, threads a CTA) of a kernel at a launch's
    shared memory, from its `rtnw_*_occupancy` query in the library (see
    SIGNATURES), with that launch's size arguments."""
    ctas, threads = ctypes.c_int(0), ctypes.c_int(0)
    err = getattr(load(), query)(*args, ctypes.byref(ctas), ctypes.byref(threads))
    if err != 0:
        raise RuntimeError(f"{query} failed: {load().rtnw_error_string(err).decode()}")
    return ctas.value, threads.value
