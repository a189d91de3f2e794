"""The plain versions of K3 (analytic closest hit) and K4 (tile-BVH
winner), and the work-list build, against the JAX reference on the CPU
(its Pallas kernels in interpret mode), plus the wrappers' device rules.
K3 and K4 themselves are held to these plain versions on a card
(test_torch_cuda.py, chip_smoke.py).

Tolerances. Codes must be equal and t within 1e-5 relative on live rays,
except on at most 0.1% of them: XLA's CPU code contracts a*b + c into
fused multiply-adds where the port rounds each operation, so a ray that
grazes an edge or meets two primitives at nearly one distance may pick the
other winner. Each test prints the fraction it sees. The work lists are
integer and min/max bookkeeping over the same slab arithmetic, held bit
for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingthenextweekcuda_tpu.models import presets as jpresets
from raytracingthenextweekcuda_tpu.models.scene import SceneBuilder as JBuilder
from raytracingthenextweekcuda_tpu.models.scene import finalize as jfinalize
from raytracingthenextweekcuda_tpu.ops.pallas import bvh_winner_kernel as jk4
from raytracingthenextweekcuda_tpu.ops.pallas import intersect_kernel as jk3
from raytracingthenextweekcuda_tpu.ops.rays import Rays as JRays
from raytracingthenextweekcuda_tpu_torch.config import EPSILON, RenderConfig
from raytracingthenextweekcuda_tpu_torch.models import camera as tcam
from raytracingthenextweekcuda_tpu_torch.models import integrator
from raytracingthenextweekcuda_tpu_torch.models import presets as tpresets
from raytracingthenextweekcuda_tpu_torch.models.scene import (
    SceneBuilder,
    finalize,
    from_jax_arrays,
)
from raytracingthenextweekcuda_tpu_torch.ops import threefry
from raytracingthenextweekcuda_tpu_torch.ops.cuda import bvh_winner_kernel as k4
from raytracingthenextweekcuda_tpu_torch.ops.cuda import intersect_kernel as k3
from raytracingthenextweekcuda_tpu_torch.ops.cuda import work
from raytracingthenextweekcuda_tpu_torch.ops.fused import device_scene, mesh_query
from raytracingthenextweekcuda_tpu_torch.ops.materials import material_table
from raytracingthenextweekcuda_tpu_torch.ops.rays import Rays

MAX_FLIP = 1e-3   # fraction of live rays whose winner may differ
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _no_reference_cache(monkeypatch):
    monkeypatch.setenv("RTNW_BVH_CACHE", "")


def _random_rays(n, seed, box=3.0):
    g = np.random.default_rng(seed)
    o = g.uniform(-box, box, (n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = g.random(n).astype(np.float32)
    alive = g.random(n) > 0.1
    return o, d, tm, alive


def _rays_pair(o, d, tm):
    return (JRays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm)),
            Rays(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tm)))


def _soup(n_sph, n_pla, n_tri, seed):
    """A random JAX scene of moving spheres, planes and a triangle soup."""
    g = np.random.default_rng(seed)
    b = JBuilder()
    b.lambertian(0, (0.5, 0.5, 0.5))
    for _ in range(n_sph):
        c = g.uniform(-2, 2, 3)
        b.moving_sphere(c, c + g.uniform(-0.2, 0.2, 3), 0.0, 1.0,
                        float(g.uniform(0.02, 0.2)), 0)
    for k in range(n_pla):
        axis = k % 3  # orientations XY, YZ, XZ
        normal = [(0.0, 0.0, 1.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0)][axis]
        b.plane(tuple(g.uniform(-2, 2, 3)), normal, tuple(g.uniform(0.2, 1.0, 3)),
                axis, 0, two_sided=bool(k % 2))
    if n_tri:
        tri = g.uniform(-2, 2, (n_tri, 1, 3)) + g.uniform(-0.3, 0.3, (n_tri, 3, 3))
        b.mesh(tri.astype(np.float32), 0)
    return b.build()


def _port_scene(jscene):
    arrays = {f"{part}.{field}": np.asarray(getattr(getattr(jscene, part), field))
              for part in ("spheres", "planes", "triangles", "materials", "mesh_info")
              for field in getattr(jscene, part)._fields}
    return from_jax_arrays(arrays)


def _compare(name, t_ref, c_ref, t_out, c_out, live):
    t_ref, c_ref = np.asarray(t_ref)[live], np.asarray(c_ref)[live]
    t_out, c_out = t_out.numpy()[live], c_out.numpy()[live]
    differ = c_ref != c_out
    close = np.isclose(t_out, t_ref, rtol=RTOL, atol=0.0)
    frac = float((differ | ~close).mean())
    print(f"{name}: {frac:.4%} of {live.sum()} live rays differ")
    assert frac <= MAX_FLIP, f"{name}: {frac:.4%} of live rays differ"
    assert (c_ref >= 0).sum() > 0.05 * live.sum()  # the rays do hit things
    return frac


# ---- K3 ------------------------------------------------------------------

# (spheres, planes, triangles): the reference's scalar variant (<= 2048
# primitives) and its lane-tiled one, with and without triangles.
SOUPS = {"scalar": (40, 6, 300), "lane_tiled": (2100, 9, 300)}


@pytest.mark.parametrize("soup", sorted(SOUPS))
@pytest.mark.parametrize("triangles", [True, False])
def test_k3_plain_matches_reference(soup, triangles):
    """Without triangles the reference packs the same spheres and planes
    with no triangles at all: its lane-tiled kernel cannot run with
    include_triangles=False (tracing slices a 128-wide tile from its
    1-column triangle stub)."""
    jscene = _soup(*SOUPS[soup], seed=1)
    n_sph, n_pla, n_tri = SOUPS[soup]
    n_prims = n_sph + n_pla + (n_tri if triangles else 0)
    assert (n_prims <= jk3.SCALAR_KERNEL_MAX_PRIMS) == (soup == "scalar")
    o, d, tm, alive = _random_rays(8192, seed=2)
    jr, tr = _rays_pair(o, d, tm)
    ref_scene = jscene if triangles else _soup(n_sph, n_pla, 0, seed=1)
    t_ref, c_ref = jk3.intersect_packed(
        jr, jk3.pack_scene_host(ref_scene), EPSILON, interpret=True,
        alive=jnp.asarray(alive))
    packed = k3.pack_scene_host(_port_scene(jscene))
    before = k3.KERNEL_LAUNCHES
    t_out, c_out = k3.intersect_packed(
        tr, k3.analytic_rows(packed, "cpu", include_triangles=triangles),
        EPSILON, alive=torch.from_numpy(alive))
    assert k3.KERNEL_LAUNCHES == before  # CPU tensors: the plain version
    assert t_out.dtype == torch.float32 and c_out.dtype == torch.int32
    # Dead rays: (BIG, -1).
    assert (c_out.numpy()[~alive] == -1).all()
    assert (t_out.numpy()[~alive] == np.float32(k3.BIG)).all()
    _compare(f"K3 {soup} triangles={triangles}", t_ref, c_ref, t_out, c_out, alive)


# ---- work lists and K4 -----------------------------------------------------

def _mesh_wavefronts():
    """(reference scene, port DeviceScene, [(name, o, d, tm, alive, tcap)]):
    the primary and the bounce-1 wavefronts of the tile-BVH mesh_showcase
    at 24x24, 2 spp, as the port's sorted engine traces them."""
    jscene, _ = jpresets.mesh_showcase(16, 32)
    tscene, camera = tpresets.mesh_showcase(16, 32)
    tscene = finalize(tscene)
    cfg = RenderConfig(width=24, height=24, spp=2, bounces=4, spp_per_pass=2)
    words = threefry.split(threefry.key(3), 2)
    ds = device_scene(tscene, "cpu")
    rays, ctx = tcam.generate_rays_multi(tcam.derive(camera, 1.0), words, 24, 24)
    n = rays.count
    state = (rays, torch.ones((n, 3)), torch.zeros((n, 3)),
             torch.ones((n,), dtype=torch.bool))
    out = []
    for b in range(2):
        t_sel, code = k3.intersect_packed(state[0], ds.analytic, EPSILON,
                                          alive=state[3])
        _, t_cap = mesh_query(ds.leaves, state[0], EPSILON, state[3], t_sel, code)
        r = state[0]
        out.append((("primary", "bounce1")[b], r.origin.numpy(),
                    r.direction.numpy(), r.time.numpy(), state[3].numpy(),
                    t_cap.numpy()))
        state = integrator._bounce_body(ds, material_table(tscene.materials, "cpu"),
                                        tscene.packed.used_kinds, cfg, state, ctx, b)
    return jfinalize(jscene), tscene, ds, out


@pytest.fixture(scope="module")
def mesh_wavefronts():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RTNW_BVH_CACHE", "")
        return _mesh_wavefronts()


@pytest.mark.parametrize("frustum", [False, True], ids=["exact", "frustum"])
@pytest.mark.parametrize("front", [0, 1], ids=["primary", "bounce1"])
@pytest.mark.parametrize("with_tcap", [False, True], ids=["nocap", "tcap"])
def test_worklist_matches_reference(mesh_wavefronts, front, frustum, with_tcap):
    jscene, tscene, ds, fronts = mesh_wavefronts
    _, o, d, _, alive, tcap = fronts[front]
    pad = -o.shape[0] % 128
    o = np.concatenate([o, np.zeros((pad, 3), np.float32)])
    d = np.concatenate([d, np.zeros((pad, 3), np.float32)])
    alive = np.concatenate([alive, np.zeros(pad, bool)])
    tcap = np.concatenate([tcap, np.full(pad, k3.BIG, np.float32)])
    ref = jk4.build_worklist(
        *(jnp.asarray(o[:, a]) for a in range(3)),
        *(jnp.asarray(d[:, a]) for a in range(3)),
        jnp.asarray(alive.astype(np.int32)), jnp.asarray(tscene.packed.leaf_bounds),
        tmin=EPSILON, block=128, frustum=frustum,
        tcap=jnp.asarray(tcap) if with_tcap else None)
    out = k4.build_worklist(torch.from_numpy(o), torch.from_numpy(d),
                            torch.from_numpy(alive), ds.leaves.leaf_bounds,
                            EPSILON, tcap=torch.from_numpy(tcap) if with_tcap else None,
                            frustum=frustum)
    counts = np.asarray(ref[0]).ravel()
    np.testing.assert_array_equal(counts, out.counts.numpy())
    assert counts.sum() > 0
    order, entry = np.asarray(ref[1])[:, 0], np.asarray(ref[2])[:, 0]
    for b, c in enumerate(counts):
        assert set(order[b, :c]) == set(out.order[b, :c].tolist())
    np.testing.assert_array_equal(entry, out.entry.numpy())


def test_frustum_threshold():
    assert not k4.use_frustum_worklist(k4.FRUSTUM_LEAF_THRESHOLD)
    assert k4.use_frustum_worklist(k4.FRUSTUM_LEAF_THRESHOLD + 1)
    assert k4.FRUSTUM_LEAF_THRESHOLD == jk4.FRUSTUM_LEAF_THRESHOLD


@pytest.mark.parametrize("front", [0, 1], ids=["primary", "bounce1"])
@pytest.mark.parametrize("with_tcap", [False, True], ids=["nocap", "tcap"])
def test_k4_plain_matches_reference(mesh_wavefronts, front, with_tcap):
    jscene, tscene, ds, fronts = mesh_wavefronts
    _, o, d, tm, alive, tcap = fronts[front]
    jr, tr = _rays_pair(o, d, tm)
    cap = tcap if with_tcap else None
    t_ref, c_ref = jk4.intersect_packed_bvh(
        jr, jscene.packed, EPSILON, interpret=True, alive=jnp.asarray(alive),
        t_cap=None if cap is None else jnp.asarray(cap))
    before = k4.KERNEL_LAUNCHES
    t_out, c_out = k4.intersect_packed_bvh(
        tr, ds.leaves, EPSILON, alive=torch.from_numpy(alive),
        t_cap=None if cap is None else torch.from_numpy(cap))
    assert k4.KERNEL_LAUNCHES == before
    assert (c_out.numpy()[~alive] == -1).all()
    _compare(f"K4 front={front} tcap={with_tcap}", t_ref, c_ref, t_out, c_out,
             alive)


def test_k4_walk_is_order_independent(mesh_wavefronts):
    """A permutation of the wavefront changes the blocks and their lists,
    not a ray's winner (the invariant the sort relies on)."""
    _, tscene, ds, fronts = mesh_wavefronts
    _, o, d, tm, alive, tcap = fronts[1]
    rays = Rays(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tm))
    a, c = torch.from_numpy(alive), torch.from_numpy(tcap)
    t0, c0 = k4.intersect_packed_bvh(rays, ds.leaves, EPSILON, alive=a, t_cap=c)
    perm = torch.from_numpy(np.random.default_rng(0).permutation(len(o)))
    t1, c1 = k4.intersect_packed_bvh(rays.take(perm), ds.leaves, EPSILON,
                                     alive=a[perm], t_cap=c[perm])
    np.testing.assert_array_equal(t0[perm].numpy(), t1.numpy())
    np.testing.assert_array_equal(c0[perm].numpy(), c1.numpy())


def test_k4_plain_counts_its_work(mesh_wavefronts):
    """The plain K4 counts the work its inputs need (ops/cuda/work.py): the
    live rays' leaf box tests, the leaves they enter, and those leaves'
    triangles, without the zero padding of their tiles."""
    _, tscene, ds, fronts = mesh_wavefronts
    _, o, d, tm, alive, tcap = fronts[0]
    leaves = ds.leaves
    per_leaf = work.tile_triangles(leaves.trih[0:3], leaves.leaf_tiles, leaves.tile)
    assert int(per_leaf.sum()) == int((tscene.triangles.mesh_id >= 0).sum())
    assert int(per_leaf.sum()) < leaves.n_leaves * leaves.tile
    work.reset()
    k4.intersect_packed_bvh(Rays(torch.from_numpy(o), torch.from_numpy(d),
                                 torch.from_numpy(tm)), leaves, EPSILON,
                            alive=torch.from_numpy(alive),
                            t_cap=torch.from_numpy(tcap))
    counts = work.WORK
    assert counts["bounces"] == 0
    assert 0 < counts["leaf_visits"] <= counts["box_tests"]
    assert (counts["leaf_visits"] <= counts["triangle_tests"]
            <= counts["leaf_visits"] * int(per_leaf.max()))


def test_k4_plain_counts_block_leaves(mesh_wavefronts):
    """The plain K4 counts the (block, leaf) pairs it evaluates: every pair
    has at least one and at most BLOCK rays that enter the leaf, so the
    mean needing rays a pair, leaf_visits / block_leaves, lies in [1, 128]."""
    _, _, ds, fronts = mesh_wavefronts
    for _, o, d, tm, alive, tcap in fronts:
        work.reset()
        k4.intersect_packed_bvh(Rays(torch.from_numpy(o), torch.from_numpy(d),
                                     torch.from_numpy(tm)), ds.leaves, EPSILON,
                                alive=torch.from_numpy(alive),
                                t_cap=torch.from_numpy(tcap))
        pairs, visits = work.WORK["block_leaves"], work.WORK["leaf_visits"]
        assert 0 < pairs <= visits <= k4.BLOCK * pairs


# ---- K4's leaf layout: real columns and the staging copy --------------------

def _uneven_mesh():
    """Two clumps of a triangle soup, 1,100 and 300 triangles: the tile-BVH
    cuts leaves of different fill."""
    g = np.random.default_rng(9)
    tri = np.concatenate([
        g.uniform(-2, 0, (1100, 1, 3)) + g.uniform(-0.2, 0.2, (1100, 3, 3)),
        g.uniform(1, 2, (300, 1, 3)) + g.uniform(-0.2, 0.2, (300, 3, 3))])
    b = SceneBuilder()
    b.lambertian(0, (0.5, 0.5, 0.5))
    b.mesh(tri.astype(np.float32), 0)
    return b.build()


def _leaf_mesh(name):
    """(finalized scene, LeafScene on the CPU) of a stand-in or the uneven
    soup."""
    from raytracingthenextweekcuda_tpu_torch.apps import bench_scenes

    if name == "uneven":
        scene = _uneven_mesh()
    else:
        scene = getattr(bench_scenes, f"{name}_mesh_scene")()[0]
    scene = finalize(scene, use_bvh=True)
    return scene, k4.leaf_scene(scene.packed, "cpu")


LEAF_MESHES = ["published", "stress", "uneven"]


@pytest.mark.parametrize("name", LEAF_MESHES)
def test_leaf_count_is_the_real_prefix(name):
    """leaf_count is each tile's count of real triangles (those with a
    nonzero normal, work.tile_triangles), and they fill the tile from the
    front: the slots before the count hold triangles of the mesh, the rest
    are padding with all 12 geometry rows zero."""
    scene, leaves = _leaf_mesh(name)
    count = leaves.leaf_count
    assert count.dtype == torch.int32 and count.shape == (leaves.n_leaves,)
    np.testing.assert_array_equal(
        count.numpy(), work.tile_triangles(leaves.trih[0:3], leaves.leaf_tiles,
                                           leaves.tile).numpy())
    assert leaves.max_count == int(count.max()) <= leaves.tile
    real = np.asarray(scene.triangles.mesh_id) >= 0
    trih = leaves.trih.numpy()
    for first, c in zip(leaves.leaf_tiles.tolist(), count.tolist()):
        assert real[first: first + c].all()
        assert not real[first + c: first + leaves.tile].any()
        assert not trih[:, first + c: first + leaves.tile].any()
    assert int(count.sum()) == int(real.sum())
    if name == "uneven":
        assert len(set(count.tolist())) > 1


@pytest.mark.parametrize("name", LEAF_MESHES)
def test_aos_copy_holds_the_havel_rows(name):
    """K4's staging copy: column c of the tiles is row c of `aos`, the 12
    Havel geometry rows in order (n.xyz dc, e1p d1, e2p d2: three 16-byte
    vectors), for every real column."""
    _, leaves = _leaf_mesh(name)
    assert leaves.aos.shape == (leaves.n_leaves * leaves.tile, k4.HAVEL_GEOM_ROWS)
    assert leaves.aos.dtype == torch.float32 and leaves.aos.is_contiguous()
    cols = torch.cat([torch.arange(f, f + c) for f, c in
                      zip(leaves.leaf_tiles.tolist(), leaves.leaf_count.tolist())])
    np.testing.assert_array_equal(leaves.aos[cols].numpy(),
                                  leaves.trih[:, cols].t().numpy())


def test_real_columns_end_at_the_last_normal():
    """A zero column inside a tile stays in the count (only the trailing
    zero columns are cut); an empty tile counts 0."""
    normals = torch.zeros((3, 12))
    normals[2, [0, 2, 4, 5, 9]] = 1.0
    count = k4.real_columns(normals, torch.tensor([0, 4, 8], dtype=torch.int32), 4)
    assert count.tolist() == [3, 2, 2]
    empty = k4.real_columns(normals, torch.tensor([6], dtype=torch.int32), 2)
    assert empty.tolist() == [0]


def _tie_scene():
    """A 20-triangle fan facing +z plus an exact duplicate of triangle 7:
    one leaf, where the two copies meet every ray at the same t."""
    b = SceneBuilder()
    b.lambertian(0, (0.5, 0.5, 0.5))
    ang = np.linspace(0.0, 2 * np.pi, 21)
    tri = np.zeros((21, 3, 3), np.float32)
    tri[:20, 1, 0], tri[:20, 1, 1] = np.cos(ang[:-1]), np.sin(ang[:-1])
    tri[:20, 2, 0], tri[:20, 2, 1] = np.cos(ang[1:]), np.sin(ang[1:])
    tri[20] = tri[7]
    b.mesh(tri, 0)
    return finalize(b.build(), use_bvh=True), tri[7]


def test_k4_plain_tie_takes_the_lower_column():
    """Equal t at two columns: the plain K4 (like the sequential scan)
    returns the lower column, the tie rule K4's lexicographic reduction
    keeps."""
    scene, dup = _tie_scene()
    leaves = k4.leaf_scene(scene.packed, "cpu")
    assert leaves.n_leaves == 1
    verts = np.asarray(scene.triangles.vertices)
    cols = np.flatnonzero((verts == dup).all(axis=(1, 2)))
    assert cols.size == 2
    g = np.random.default_rng(4)
    n = 256
    bary = g.dirichlet((1.0, 1.0, 1.0), n).astype(np.float32)
    target = bary @ dup
    jitter = g.uniform(-0.05, 0.05, (n, 3)).astype(np.float32)
    o = target + np.float32([0.0, 0.0, 2.0]) + jitter
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = Rays(torch.from_numpy(o), torch.from_numpy(d.astype(np.float32)),
                torch.zeros(n))
    # The fan faces +z, so rays from above meet its front faces.
    t, code = k4.intersect_packed_bvh(rays, leaves, EPSILON)
    hit = code.numpy() == ((k3.TYPE_TRIANGLE << 24) | int(cols[0]))
    assert not (code.numpy() == ((k3.TYPE_TRIANGLE << 24) | int(cols[1]))).any()
    assert hit.mean() > 0.9


def test_k4_plain_on_cut_tiles_equals_full_tiles(mesh_wavefronts):
    """The plain K4 on tiles cut to their real columns (max_count wide)
    equals it on the full 768-column tiles, column for column: the padding
    K4 no longer scans can never win."""
    _, _, ds, fronts = mesh_wavefronts
    full = ds.leaves
    w = full.max_count
    assert w < full.tile
    cols = (full.leaf_tiles.to(torch.int64)[:, None] + torch.arange(w)).flatten()
    trih = full.trih[:, cols].contiguous()
    cut = full._replace(trih=trih, tile=w,
                        leaf_tiles=torch.arange(full.n_leaves, dtype=torch.int32) * w,
                        aos=trih.t().contiguous())
    for _, o, d, tm, alive, tcap in fronts:
        rays = Rays(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tm))
        a, c = torch.from_numpy(alive), torch.from_numpy(tcap)
        t0, c0 = k4.intersect_packed_bvh(rays, full, EPSILON, alive=a, t_cap=c)
        t1, c1 = k4.intersect_packed_bvh(rays, cut, EPSILON, alive=a, t_cap=c)
        np.testing.assert_array_equal(t0.numpy(), t1.numpy())
        hit = c1 >= 0
        assert int(hit.sum()) > 0
        back = cols[(c1[hit] & 0xFFFFFF).to(torch.int64)].to(torch.int32)
        np.testing.assert_array_equal(c0[hit].numpy(),
                                      ((k3.TYPE_TRIANGLE << 24) | back).numpy())
        np.testing.assert_array_equal(c0[~hit].numpy(), c1[~hit].numpy())


# ---- device rules ----------------------------------------------------------

def test_launches_check_their_inputs():
    o, d, tm, alive = _random_rays(256, seed=5)
    rows = k3.analytic_rows(k3.pack_scene_host(_port_scene(_soup(4, 2, 3, 0))), "cpu")
    with pytest.raises(ValueError, match="K3 input"):
        k3._launch(torch.from_numpy(o).double(), torch.from_numpy(d),
                   torch.from_numpy(tm), torch.from_numpy(alive), rows, EPSILON)
    tscene = finalize(tpresets.mesh_showcase(16, 32)[0])
    leaves = k4.leaf_scene(tscene.packed, "cpu")
    rays = Rays(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tm))
    args = k4.winner_inputs(rays, leaves, EPSILON, torch.from_numpy(alive))
    bad = (args[0], args[1], args[2].to(torch.uint8), args[3], args[4])
    with pytest.raises(ValueError, match="K4 input"):
        k4._launch(*bad, leaves, EPSILON)
    for bad_leaves in (leaves._replace(leaf_count=leaves.leaf_count.long()),
                       leaves._replace(leaf_count=leaves.leaf_count[:-1]),
                       leaves._replace(aos=leaves.aos.t()),
                       leaves._replace(aos=leaves.aos[:, :9].contiguous()),
                       leaves._replace(aos=leaves.aos.double())):
        with pytest.raises(ValueError, match="K4 input"):
            k4._launch(*args, bad_leaves, EPSILON)
    with pytest.raises(ValueError, match="leaf buffer"):
        k4._launch(*args, leaves._replace(max_count=leaves.tile + 1), EPSILON)


def test_launch_without_nvcc_raises(tmp_path, monkeypatch):
    """The kernel paths never fall back: without a CUDA toolkit the build
    raises instead of selecting."""
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import build

    if build.shutil.which("nvcc") or build.os.path.isfile("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is installed here")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_LIB", None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    o, d, tm, alive = _random_rays(256, seed=6)
    rows = k3.analytic_rows(k3.pack_scene_host(_port_scene(_soup(4, 2, 3, 0))), "cpu")
    before3, before4 = k3.KERNEL_LAUNCHES, k4.KERNEL_LAUNCHES
    with pytest.raises(RuntimeError, match="nvcc not found"):
        k3._launch(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tm),
                   torch.from_numpy(alive), rows, EPSILON)
    tscene = finalize(tpresets.mesh_showcase(16, 32)[0])
    leaves = k4.leaf_scene(tscene.packed, "cpu")
    rays = Rays(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tm))
    args = k4.winner_inputs(rays, leaves, EPSILON, torch.from_numpy(alive))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        k4._launch(*args, leaves, EPSILON)
    assert (k3.KERNEL_LAUNCHES, k4.KERNEL_LAUNCHES) == (before3, before4)
