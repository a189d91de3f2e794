"""The launch seam of the hand-written kernels (ops/cuda/launch.py) and the
library's C signatures (ops/cuda/build.SIGNATURES), on the CPU.

- The ABI: every `extern "C"` entry of csrc/*.cu has its table entry, with
  as many parameters, each of the C parameter's type, and `load` sets each
  entry from the table.
- The seam: `check`'s message on a wrong device, dtype, shape or layout;
  `by_device` on a device that is neither CUDA nor CPU; `call`'s stream,
  error text and counting; a CPU call of each public wrapper runs the plain
  version and counts no launch.
- An AST guard: the dispatch, the stream, the launch counter and the device
  rule live in launch.py only.

No render runs here: the wavefronts are 16 to 64 rays.
"""

import ast
import collections
import contextlib
import ctypes
import pathlib
import re
import types

import pytest
import torch

from raytracingthenextweekcuda_tpu_torch.config import EPSILON, RenderConfig
from raytracingthenextweekcuda_tpu_torch.models import camera as tcam
from raytracingthenextweekcuda_tpu_torch.models import presets
from raytracingthenextweekcuda_tpu_torch.models.scene import finalize
from raytracingthenextweekcuda_tpu_torch.ops import rng, threefry
from raytracingthenextweekcuda_tpu_torch.ops.cuda import bounce_kernel as bk
from raytracingthenextweekcuda_tpu_torch.ops.cuda import build, launch
from raytracingthenextweekcuda_tpu_torch.ops.cuda import bvh_winner_kernel as k4
from raytracingthenextweekcuda_tpu_torch.ops.cuda import intersect_kernel as k3
from raytracingthenextweekcuda_tpu_torch.ops.cuda import shade_kernel as sk
from raytracingthenextweekcuda_tpu_torch.ops.fused import device_scene, winners
from raytracingthenextweekcuda_tpu_torch.ops.materials import material_table

PACKAGE = pathlib.Path(build.__file__).resolve().parents[2]
CUDA_DIR = PACKAGE / "ops" / "cuda"

# ---- the ABI ---------------------------------------------------------------

_EXTERN = re.compile(r'extern\s+"C"\s+([\w\s\*]+?)\s*\b(rtnw_\w+)\s*\(([^)]*)\)')
_SCALARS = {"int": ctypes.c_int, "float": ctypes.c_float, "uint32_t": ctypes.c_uint32,
            "long long": ctypes.c_longlong}


def _csrc_entries() -> dict:
    """{name: (return type, [parameter declarations])} of csrc/*.cu."""
    out = {}
    for src in sorted(build.CSRC_DIR.glob("*.cu")):
        text = re.sub(r"//[^\n]*", "", src.read_text())
        for ret, name, params in _EXTERN.findall(text):
            assert name not in out, f"{name} defined twice"
            out[name] = (" ".join(ret.split()),
                         [" ".join(p.split()) for p in params.split(",") if p.strip()])
    return out


def _ctype(decl: str):
    """The ctypes types a C parameter declaration may be given: c_void_p or
    a pointer to the pointee's type for a pointer, the type for a scalar."""
    words = decl.replace("*", " * ").split()[:-1]  # the name goes
    base = " ".join(w for w in words if w not in ("const", "*"))
    if "*" in words:
        scalar = _SCALARS.get(base)
        return (ctypes.c_void_p,) + ((ctypes.POINTER(scalar),) if scalar else ())
    return (_SCALARS[base],)


def test_every_csrc_entry_has_a_signature():
    entries = _csrc_entries()
    launches = {n for n, (ret, _) in entries.items() if ret == "int"}
    assert launches == set(build.SIGNATURES)
    assert {n: entries[n] for n in set(entries) - launches} == {
        "rtnw_error_string": ("const char*", ["int err"])}


@pytest.mark.parametrize("entry", sorted(build.SIGNATURES))
def test_signature_matches_csrc(entry):
    """The table's parameters are the C entry's, in number and in type."""
    ret, params = _csrc_entries()[entry]
    argtypes = build.SIGNATURES[entry]
    assert ret == "int"
    assert len(argtypes) == len(params), f"{entry}: {len(argtypes)} != {params}"
    for k, (decl, t) in enumerate(zip(params, argtypes)):
        assert t in _ctype(decl), f"{entry} parameter {k} `{decl}`: {t}"


def test_load_sets_every_entry_from_the_table(monkeypatch):
    class Lib:
        def __init__(self, path):
            self.path = path

        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(build, "_LIB", None)
    monkeypatch.setattr(build, "build", lambda: pathlib.Path("librtnw_kernels.so"))
    monkeypatch.setattr(build.ctypes, "CDLL", Lib)
    lib = build.load()
    assert build.load() is lib and lib.path == "librtnw_kernels.so"
    for name, argtypes in build.SIGNATURES.items():
        fn = getattr(lib, name)
        assert tuple(fn.argtypes) == argtypes and fn.restype is ctypes.c_int
    assert lib.rtnw_error_string.argtypes == [ctypes.c_int]
    assert lib.rtnw_error_string.restype is ctypes.c_char_p


# ---- the seam --------------------------------------------------------------

def _bad_specs():
    good = torch.zeros((4, 3))
    yield "device", good.to("meta"), "(4, 3) torch.float32 on meta"
    yield "dtype", good.double(), "(4, 3) torch.float64 on cpu"
    yield "shape", good[:3], "(3, 3) torch.float32 on cpu"
    yield "layout", good.t().contiguous().t(), "(4, 3) torch.float32 on cpu"


@pytest.mark.parametrize("what,tensor,seen", list(_bad_specs()),
                         ids=[b[0] for b in _bad_specs()])
def test_check_raises_the_message(what, tensor, seen):
    cpu = torch.device("cpu")
    ok = torch.zeros((2,), dtype=torch.int32)
    launch.check("K3", cpu, ((ok, torch.int32, (2,)), (torch.zeros((4, 3)),
                                                       torch.float32, (4, 3))))
    with pytest.raises(ValueError) as err:
        launch.check("K3", cpu, ((ok, torch.int32, (2,)),
                                 (tensor, torch.float32, (4, 3))))
    assert str(err.value) == (f"K3 input {seen}: expected contiguous (4, 3) "
                              f"torch.float32 on cpu")


def test_by_device_routes_and_raises_on_other_devices():
    def launch_(*args):
        return "kernel", args

    def plain(*args):
        return "plain", args

    assert launch.by_device(torch.device("cpu"), launch_, plain, 1, 2) == ("plain", (1, 2))
    assert launch.by_device(torch.device("cuda", 0), launch_, plain, 3) == ("kernel", (3,))
    with pytest.raises(ValueError, match="^unsupported device meta$"):
        launch.by_device(torch.zeros(1, device="meta").device, launch_, plain)


def test_call_passes_the_stream_raises_and_counts(monkeypatch):
    """`call` appends the current stream, counts a launch that returns 0
    under each name given and raises on any other return, counting none."""
    class Lib:
        def __init__(self):
            self.ret, self.seen = 0, []

        def rtnw_worklist(self, *args):
            self.seen.append(args)
            return self.ret

        def rtnw_error_string(self, err):
            return b"an error"

    lib = Lib()
    counts = collections.Counter()
    monkeypatch.setattr(build, "_LIB", lib)
    monkeypatch.setattr(launch, "LAUNCHES", counts)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=77))
    cpu = torch.device("cpu")
    launch.call("K1", "rtnw_worklist", cpu, 1, None, 2.5, count=("K1", "K1-BVH"))
    assert lib.seen == [(1, None, 2.5, 77)] and counts == {"K1": 1, "K1-BVH": 1}
    lib.ret = 700
    with pytest.raises(RuntimeError) as err:
        launch.call("work-list", "rtnw_worklist", cpu, 3, count=("worklist",))
    assert str(err.value) == "work-list launch failed: an error (700)"
    assert counts == {"K1": 1, "K1-BVH": 1}


@pytest.fixture(scope="module")
def wrapper_calls(tmp_path_factory):
    """{wrapper: a CPU call of it} on a 4x4 Cornell box (K1, K2, K0, K3) and
    an 8x8 primary wavefront of the tile-BVH mesh stand-in (the work lists,
    K4 and the shade kernel)."""
    cfg = RenderConfig(width=4, height=4, spp=1, bounces=2)
    scene, camera = presets.cornell_box()
    packed = finalize(scene).packed
    frame = tcam.derive(camera, 1.0)
    words = threefry.split(threefry.key(0), 1)
    rays, ctx = tcam.generate_rays(frame, words[0], 4, 4)
    mesh, mcam = presets.mesh_showcase(16, 32)
    mesh = finalize(mesh, bvh_cache_dir=str(tmp_path_factory.mktemp("bvh_cache")))
    ds = device_scene(mesh, "cpu")
    mrays, _ = tcam.generate_rays_multi(tcam.derive(mcam, 1.0), words, 8, 8, "cpu")
    n = mrays.count
    state = (mrays, torch.ones((n, 3)), torch.zeros((n, 3)),
             torch.ones((n,), dtype=torch.bool))
    slots = rng.SlotCtx(None, *rng.key_bases(words, "cpu"), n, n)
    wl_args = k4.winner_inputs(mrays, ds.leaves, EPSILON)
    return {
        "render_kernel": lambda: bk.render_kernel(
            bk.render_inputs(packed, frame, words, cfg, device="cpu")),
        "path_kernel": lambda: bk.path_kernel(bk.path_inputs(packed, rays, ctx, cfg)),
        "bounce_kernel": lambda: bk.bounce_kernel(bk.bounce_inputs(
            packed, bk.planar_state(rays), torch.zeros((16, 4)), 0, cfg)),
        "intersect_packed": lambda: k3.intersect_packed(rays, k3.analytic_rows(
            packed, "cpu")),
        "build_worklist": lambda: k4.build_worklist(
            *wl_args[:3], ds.leaves.leaf_bounds, EPSILON, tcap=wl_args[3]),
        "winner": lambda: k4.winner(*wl_args, ds.leaves, EPSILON),
        "shade": lambda: sk.shade(ds, material_table(mesh.materials, "cpu"),
                                  mesh.packed.used_kinds, cfg, state,
                                  winners(ds, mrays, EPSILON), slots,
                                  torch.arange(n), 0),
    }


@pytest.mark.parametrize("wrapper", ["render_kernel", "path_kernel", "bounce_kernel",
                                     "intersect_packed", "build_worklist", "winner",
                                     "shade"])
def test_cpu_call_counts_no_launch(wrapper_calls, wrapper):
    before = launch.LAUNCHES.copy()
    assert wrapper_calls[wrapper]() is not None
    assert launch.LAUNCHES == before


# ---- the guard -------------------------------------------------------------

def _modules(root: pathlib.Path):
    for path in sorted(root.rglob("*.py")):
        yield path, ast.parse(path.read_text())


def test_launch_frame_and_device_rule_live_in_launch_only():
    for path, tree in _modules(CUDA_DIR):
        if path.name == "launch.py":
            continue
        for node in ast.walk(tree):
            assert not (isinstance(node, ast.Attribute) and node.attr == "cuda_stream"), \
                f"{path.name}:{node.lineno} reads a stream"
            assert not (isinstance(node, ast.Constant) and isinstance(node.value, str)
                        and "unsupported device" in node.value), \
                f"{path.name}:{node.lineno} dispatches by device"
            if path.name != "build.py" and isinstance(node, ast.Call):
                fn = node.func
                assert not (isinstance(fn, ast.Attribute) and fn.attr == "load"
                            and isinstance(fn.value, ast.Name) and fn.value.id == "build"), \
                    f"{path.name}:{node.lineno} loads the library"
    moved = {"device_or_raise", "FORWARD_ONLY_MESSAGE", "ForwardOnly", "grad_probe",
             "guard", "by_device", "check", "call", "LAUNCHES"}
    for path, tree in _modules(PACKAGE):
        for node in tree.body:
            names = set()
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                names = {node.name}
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                names = {t.id for t in targets if isinstance(t, ast.Name)}
            assert not {n for n in names if n.endswith("_LAUNCHES")}, \
                f"{path}:{node.lineno} binds a launch counter"
            if path.name != "launch.py" or path.parent != CUDA_DIR:
                assert not names & moved, f"{path}:{node.lineno} defines {names & moved}"
        assert not [n for n in ast.walk(tree) if isinstance(n, ast.Global)
                    and any(x.endswith("_LAUNCHES") for x in n.names)], path
