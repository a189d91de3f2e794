"""Build the package's CUDA sources at first use and load them with ctypes.

`nvcc` compiles every `csrc/*.cu` into one shared library with a plain C
interface for sm_90a (Hopper), without fast math: the kernels must round as
their plain torch versions do. The library goes into `_build/` beside the
package (gitignored), named by a hash of the sources and flags, so a change
to a source rebuilds it and an unchanged tree loads the cached file. A
failed build or load raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

PACKAGE_DIR = pathlib.Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

_LIB: ctypes.CDLL | None = None
# Seconds the last build of this process took (0.0 when the cached library
# was loaded) and what nvcc printed, including ptxas's register and spill
# report for each kernel.
BUILD_SECONDS = 0.0
BUILD_LOG = ""


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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"librtnw_kernels-{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the sources unless the library for their hash exists."""
    global BUILD_SECONDS, BUILD_LOG
    out = library_path()
    if out.exists():
        BUILD_SECONDS = 0.0
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_out = pathlib.Path(tmp) / out.name
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp_out),
               *map(str, _sources())]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        BUILD_LOG = proc.stdout + proc.stderr
        os.replace(tmp_out, out)
    BUILD_SECONDS = time.perf_counter() - t0
    return out


def load() -> ctypes.CDLL:
    """The kernels' library, built on first call, with argtypes set."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn = lib.rtnw_render_samples
        fn.argtypes = [
            vp,                      # scene rows (float*)
            ci, ci, ci, ci, ci,      # n_sph, n_pla, n_trih, n_quad, n_box
            vp,                      # frame (21 floats)
            vp, ci,                  # sample key words (2*S uint32), S
            vp, ci,                  # pixel ids (int32), n
            ci, ci,                  # width, height
            ci, ci, cf, ci,          # bounces, rr_start, tmin, flags
            vp,                      # out (n, 3) float
            vp,                      # cudaStream_t
        ]
        fn.restype = ci
        lib.rtnw_error_string.argtypes = [ci]
        lib.rtnw_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB
