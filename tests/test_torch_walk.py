"""The tile-BVH walk's inputs and its plain version, on the CPU: each leaf's
real columns (`bvh_count`) against `real_columns`, the column vectors the
kernels scan, the launch checks of both, and the plain walk's (t, column)
against a brute-force scan of every real column, with triangles duplicated
into a second leaf so that ties between leaves occur. The walk against the
JAX reference is tests/test_torch_megastep_bvh.py; the kernels against this
plain walk on a card are tests/test_torch_cuda.py, which borrows
`tie_inputs` and `inside_rays` from here. No jax is imported.
"""

import dataclasses

import numpy as np
import pytest
import torch

from raytracingthenextweekcuda_tpu_torch.apps import bench_scenes
from raytracingthenextweekcuda_tpu_torch.config import FLT_EPSILON, RenderConfig
from raytracingthenextweekcuda_tpu_torch.models.scene import SceneBuilder, finalize
from raytracingthenextweekcuda_tpu_torch.ops.cuda import bounce_kernel as bk
from raytracingthenextweekcuda_tpu_torch.ops.cuda.bvh_winner_kernel import real_columns
from raytracingthenextweekcuda_tpu_torch.ops.cuda.intersect_kernel import BIG

CFG = RenderConfig(width=8, height=8, spp=1, bounces=2)


def _soup():
    """An uneven soup: 2,000 random small triangles, 6 tile-BVH leaves whose
    real columns differ."""
    g = np.random.default_rng(4)
    b = SceneBuilder()
    b.lambertian(0, (0.5, 0.5, 0.5))
    centres = g.uniform(-2, 2, (2000, 1, 3)) * np.array([1.0, 0.2, 1.0])
    b.mesh((centres + g.uniform(-0.1, 0.1, (2000, 3, 3))).astype(np.float32), 0)
    return b.build()


SCENES = {"published": lambda: bench_scenes.published_mesh_scene()[0],
          "stress": lambda: bench_scenes.stress_mesh_scene()[0],
          "soup": _soup}


@pytest.fixture(scope="module", params=sorted(SCENES))
def walk_inputs(request):
    scene = finalize(SCENES[request.param](), use_bvh=True)
    return request.param, scene, bk.scene_inputs(scene.packed, CFG, "cpu")


def test_node_columns_equal_real_columns(walk_inputs):
    """A leaf's real columns are `real_columns` of its tile; the columns of
    the tile past them have zero normals, the last before them does not;
    interior nodes count none."""
    name, scene, inp = walk_inputs
    meta, count = inp.bvh_meta, inp.bvh_count
    leaf = meta[0] == 1
    assert count.dtype == torch.int32 and count.shape == (meta.shape[1],)
    tiles = meta[1][leaf]
    np.testing.assert_array_equal(count[leaf].numpy(),
                                  real_columns(inp.trih[0:3], tiles,
                                               inp.leaf_tile).numpy())
    assert not count[~leaf].any()
    normals = inp.trih[0:3].numpy()
    for first, n in zip(tiles.tolist(), count[leaf].tolist()):
        assert 0 < n <= inp.leaf_tile
        assert not normals[:, first + n: first + inp.leaf_tile].any()
        assert normals[:, first + n - 1].any()
    if name == "published":
        assert count[leaf].tolist() == [480, 480]
    else:
        assert len(set(count[leaf].tolist())) > 1  # uneven leaves


def test_column_vectors_hold_the_havel_rows(walk_inputs):
    """`trih_aos` row c is column c of the 12 Havel geometry rows, 16-byte
    aligned for the kernels' float4 loads."""
    _, _, inp = walk_inputs
    assert inp.trih_aos.shape == (inp.trih.shape[1], bk.HAVEL_ROWS)
    assert inp.trih_aos.is_contiguous() and inp.trih_aos.data_ptr() % 16 == 0
    np.testing.assert_array_equal(inp.trih_aos.numpy(),
                                  inp.trih[:bk.HAVEL_ROWS].numpy().T)


def test_walk_inputs_checked_before_launch(walk_inputs):
    """The launch wrappers check the real columns and the column vectors
    (shape, alignment, counts within a tile) before building anything."""
    _, scene, inp = walk_inputs
    rinp = bk.render_inputs(scene.packed, _frame(), np.zeros((1, 2), np.uint32),
                            CFG, device="cpu")
    cols = rinp.trih.shape[1]
    shifted = torch.zeros(cols * bk.HAVEL_ROWS + 1)[1:].view(cols, bk.HAVEL_ROWS)
    shifted.copy_(rinp.trih_aos)
    too_many = rinp.bvh_count.clone()
    too_many[int(torch.nonzero(rinp.bvh_meta[0] == 1)[0])] = rinp.leaf_tile + 1
    for field, value, match in (
            ("trih_aos", shifted, "aligned"),
            ("trih_aos", rinp.trih_aos[:, :9].contiguous(), "K1 input"),
            ("bvh_count", too_many, "outside its tile"),
            ("bvh_count", rinp.bvh_count[:-1].contiguous(), "K1 input")):
        with pytest.raises(ValueError, match=match):
            bk._launch(dataclasses.replace(rinp, **{field: value}))


def _frame():
    from raytracingthenextweekcuda_tpu_torch.models import camera as tcam

    _, camera, _ = bench_scenes.published_mesh_scene()
    return tcam.derive(camera, 1.0)


def tie_inputs(device, pairs=6):
    """SceneInputs of the stress stand-in (32 leaves) on `device`, where
    `pairs` triangles of early leaves are copied into the padding of late
    leaves and as many of late leaves into early ones, with the boxes of
    the receiving leaf and its ancestors grown to hold the copy: a ray that
    hits such a triangle meets it in two leaves at equal t. Returns the
    inputs and the centroids of the copied triangles."""
    scene = finalize(bench_scenes.stress_mesh_scene()[0], use_bvh=True)
    inp = bk.scene_inputs(scene.packed, CFG, "cpu")
    bounds = inp.bvh_bounds.numpy().copy()
    meta = inp.bvh_meta.numpy()
    trih = inp.trih.numpy().copy()
    verts = np.asarray(scene.triangles.vertices, np.float32)
    count = inp.bvh_count.numpy().copy()
    leaves = np.flatnonzero(meta[0] == 1)
    leaves = leaves[np.argsort(meta[1][leaves])]  # in tile (DFS) order
    g = np.random.default_rng(8)
    centroids = []
    for k in range(pairs):
        for src, dst in ((leaves[k], leaves[-1 - k]), (leaves[-1 - k], leaves[k])):
            col = meta[1][src] + int(g.integers(count[src]))
            slot = meta[1][dst] + count[dst]
            count[dst] += 1
            trih[:, slot] = trih[:, col]
            lo, hi = verts[col].min(0), verts[col].max(0)
            tile = meta[1][dst]
            grow = (meta[3] <= tile) & (tile < meta[4])  # dst and its ancestors
            bounds[0:3, grow] = np.minimum(bounds[0:3, grow], lo[:, None])
            bounds[3:6, grow] = np.maximum(bounds[3:6, grow], hi[:, None])
            centroids.append(verts[col].mean(0))
    fields = bk.tile_bvh_fields(bounds, meta, trih, inp.leaf_tile, device)
    np.testing.assert_array_equal(fields["bvh_count"].cpu().numpy(), count)
    sc = bk.scene_inputs(scene.packed, CFG, device)
    return dataclasses.replace(sc, **fields), np.asarray(centroids, np.float32)


def inside_rays(centroids, n, seed):
    """n rays from inside the stand-in's inward-wound sphere (centre (0, 0,
    -0.3), radius 0.45), so that they meet front faces: half aimed at the
    copied triangles' centroids, half in random directions."""
    g = np.random.default_rng(seed)
    centre = np.array([0.0, 0.0, -0.3], np.float32)
    o = centre + g.uniform(-0.15, 0.15, (n, 3))
    target = centroids[g.integers(len(centroids), size=n)]
    d = np.where(np.arange(n)[:, None] % 2 == 0, target - o, g.normal(size=(n, 3)))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _brute_force(inp, o, d, tmin):
    """The first strict minimum (t, column) over every real column of every
    leaf, in column order, below BIG; (BIG, -1) where nothing is hit."""
    meta, count = inp.bvh_meta.numpy(), inp.bvh_count.numpy()
    cols = np.concatenate([np.arange(f, f + c) for f, c, leaf
                           in zip(meta[1], count, meta[0] == 1) if leaf])
    cols = torch.from_numpy(np.sort(cols))
    h = inp.trih[:, cols]
    ox, oy, oz = (o[:, k, None] for k in range(3))
    dx, dy, dz = (d[:, k, None] for k in range(3))
    dn = dx * h[0] + dy * h[1] + dz * h[2]
    ok = dn < -FLT_EPSILON
    t = (h[3] - (ox * h[0] + oy * h[1] + oz * h[2])) * (
        1.0 / torch.where(ok, dn, torch.ones_like(dn)))
    hx, hy, hz = ox + t * dx, oy + t * dy, oz + t * dz
    u = h[4] * hx + h[5] * hy + h[6] * hz + h[7]
    v = h[8] * hx + h[9] * hy + h[10] * hz + h[11]
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > tmin) & (t < BIG)
    tm = torch.where(hit, t, torch.full_like(t, float("inf")))
    best, idx = tm.min(dim=1)  # torch.min returns the first index of the minimum
    found = torch.isfinite(best)
    return (torch.where(found, best, torch.full_like(best, BIG)),
            torch.where(found, cols[idx], torch.full_like(idx, -1)), tm, cols)


def test_plain_walk_equals_brute_force_with_ties():
    """The plain walk's (t, column) on the 32-leaf stress stand-in equals a
    brute-force scan of every real column (strict t < best, the lowest
    column among equal t), also where a triangle sits in two leaves."""
    inp, centroids = tie_inputs("cpu")
    o, d = inside_rays(centroids, 2048, seed=1)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    t, col = bk._tile_bvh_closest(inp, [o[:, k, None] for k in range(3)],
                                  [d[:, k, None] for k in range(3)],
                                  torch.full((o.shape[0],), BIG))
    t_bf, col_bf, tm, cols = _brute_force(inp, o, d, inp.tmin)
    assert int((col >= 0).sum()) > 0.9 * o.shape[0]
    np.testing.assert_array_equal(col.numpy(), col_bf.numpy())
    np.testing.assert_array_equal(t.numpy(), t_bf.numpy())
    # Ties between two leaves occur, and the lower column wins them.
    ties = ((tm == t_bf[:, None]).sum(dim=1) > 1) & (col_bf >= 0)
    assert int(ties.sum()) > 50
    first = cols[(tm == t_bf[:, None]).int().argmax(dim=1)]
    np.testing.assert_array_equal(col[ties].numpy(), first[ties].numpy())
