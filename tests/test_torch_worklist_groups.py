"""The work-list kernel's group cull and route, on the CPU.

The kernel (csrc/worklist_kernel.cu) tests a box around 32 consecutive
leaves before the leaves; its lists stay exact because a group box
contains its leaf boxes, so a ray that passes a leaf's slab test passes
its group's. Held here on the plain slab test with synthetic leaf boxes:
- `group_bounds`: the exact min / max of each group's leaves;
- leaf hit implies group hit on adversarial rays (axis-parallel
  directions, origins on box faces, NaN coordinates, a ceiling equal to
  the entry, entries of -0.0), and `WORK["group_misses"]` stays 0;
- the plain version's counters, and its lists unchanged by the groups;
- the route: the kernel on the card at any leaf count, the packet-frustum
  pass on CPU tensors above FRUSTUM_LEAF_THRESHOLD;
- the kernel's group width equals the Python one, and the kernel has one
  path at every leaf count.
- build_worklist and worklist_reference read the group boxes from the
  LeafScene, or derive them from bare leaf boxes.
No render and no finalize of a large scene runs here.
"""

import re

import numpy as np
import pytest
import torch

from raytracingthenextweekcuda_tpu_torch.config import EPSILON
from raytracingthenextweekcuda_tpu_torch.models import presets
from raytracingthenextweekcuda_tpu_torch.models.scene import finalize
from raytracingthenextweekcuda_tpu_torch.ops.cuda import build, work
from raytracingthenextweekcuda_tpu_torch.ops.cuda import bvh_winner_kernel as k4
from raytracingthenextweekcuda_tpu_torch.ops.cuda.intersect_kernel import BIG
from raytracingthenextweekcuda_tpu_torch.ops.wavefront_sort import safe_inv


def _boxes(n_leaves: int, seed: int) -> torch.Tensor:
    """(6, L) float32 leaf boxes in [-1, 1]^3 laid out along x in leaf
    order, as DFS order keeps neighbours together."""
    g = np.random.default_rng(seed)
    c = g.uniform(-1, 1, (n_leaves, 3))
    c[:, 0] = np.sort(c[:, 0])
    h = g.uniform(0.005, 0.05, (n_leaves, 3))
    return torch.from_numpy(np.concatenate([c - h, c + h], axis=1).T.astype(np.float32)
                            .copy())


@pytest.mark.parametrize("n_leaves", [1, 31, 32, 33, 84, 2049])
def test_group_bounds_contain_their_leaves(n_leaves):
    lb = _boxes(n_leaves, n_leaves)
    gb = k4.group_bounds(lb)
    G = -(-n_leaves // k4.WL_GROUP)
    assert gb.shape == (6, G) and gb.dtype == torch.float32 and gb.is_contiguous()
    for g in range(G):
        leaves = lb[:, g * k4.WL_GROUP: (g + 1) * k4.WL_GROUP].numpy()
        assert np.array_equal(gb[0:3, g].numpy(), leaves[0:3].min(axis=1))
        assert np.array_equal(gb[3:6, g].numpy(), leaves[3:6].max(axis=1))
        assert (gb[0:3, g, None].numpy() <= leaves[0:3]).all()
        assert (gb[3:6, g, None].numpy() >= leaves[3:6]).all()


def test_leaf_scene_carries_its_group_bounds(tmp_path):
    scene = finalize(presets.mesh_showcase(16, 32)[0], bvh_cache_dir=str(tmp_path))
    leaves = k4.leaf_scene(scene.packed, "cpu")
    assert torch.equal(leaves.group_bounds, k4.group_bounds(leaves.leaf_bounds))


def _adversarial_rays(lb: torch.Tensor):
    """Rays that stress the slab test's rounding against the leaf boxes
    `lb`: from each of 16 leaves' face centres, axis-parallel both ways
    (the other components +0.0 or -0.0, safe_inv's 1e20), so that the
    entry is +0.0 or -0.0; a ceiling equal to that entry; rays aimed at
    leaf corners from outside; and rays with a NaN coordinate. Returns
    (origin, direction, alive, tcap), padded to whole blocks, and the rows
    with a NaN."""
    lo, hi = lb[0:3].t(), lb[3:6].t()
    centre = (lo + hi) / 2
    rows = []
    for leaf in range(0, lb.shape[1], max(1, lb.shape[1] // 16)):
        for axis in range(3):
            for face, sign in ((lo, 1.0), (hi, -1.0)):
                o = centre[leaf].clone()
                o[axis] = face[leaf, axis]
                for zero in (0.0, -0.0):
                    d = torch.full((3,), zero)
                    d[axis] = sign
                    rows.append((o, d, 0.0))       # entry +-0.0, on the face
                    rows.append((o, -d, 0.0))      # leaving through the face
                    rows.append((o, d, -1.0))      # the ceiling at the entry
    g = torch.Generator().manual_seed(lb.shape[1])
    for leaf in range(0, lb.shape[1], max(1, lb.shape[1] // 32)):
        o = torch.rand(3, generator=g) * 6 - 3
        rows.append((o, lo[leaf] - o, 0.0))
        rows.append((o, hi[leaf] - o, 0.0))
    origin = torch.stack([r[0] for r in rows])
    direction = torch.stack([r[1] for r in rows])
    tcap = torch.full((len(rows),), BIG)
    n_nan = 4
    origin = torch.cat([origin, origin[:n_nan]])
    direction = torch.cat([direction, direction[:n_nan]])
    tcap = torch.cat([tcap, tcap[:n_nan]])
    nan = torch.arange(len(rows), len(rows) + n_nan)
    origin[nan[0], 0] = float("nan")
    origin[nan[1], 2] = float("nan")
    direction[nan[2], 1] = float("nan")
    tcap[nan[3]] = float("nan")
    # The ceiling at the entry: the leaf's own slab entry, exactly.
    at_entry = torch.tensor([r[2] < 0 for r in rows] + [False] * n_nan)
    tn, _ = k4._slab(lb, origin[:, None, :], safe_inv(direction)[:, None, :])
    entry = torch.where(tn >= 0, tn, torch.full_like(tn, BIG)).amin(dim=1)
    tcap = torch.where(at_entry, entry, tcap)
    pad = -origin.shape[0] % k4.BLOCK
    alive = torch.cat([torch.ones(origin.shape[0], dtype=torch.bool),
                       torch.zeros(pad, dtype=torch.bool)])
    origin = torch.cat([origin, torch.zeros((pad, 3))])
    direction = torch.cat([direction, torch.zeros((pad, 3))])
    tcap = torch.cat([tcap, torch.full((pad,), BIG)])
    return origin, direction, alive, tcap, nan


def _hits(box, origin, direction, alive, tcap):
    """The plain slab test's hits (rays, boxes) of the boxes `box` (6, N)."""
    tn, tf = k4._slab(box, origin[:, None, :], safe_inv(direction)[:, None, :])
    return (tf >= tn) & (tf >= EPSILON) & (tn <= tcap[:, None]) & alive[:, None]


@pytest.mark.parametrize("n_leaves", [33, 84, 2049])
def test_leaf_hit_implies_group_hit(n_leaves):
    lb = _boxes(n_leaves, 7 + n_leaves)
    gb = k4.group_bounds(lb)
    origin, direction, alive, tcap, nan = _adversarial_rays(lb)
    leaf_hit = _hits(lb, origin, direction, alive, tcap)
    group_hit = _hits(gb, origin, direction, alive, tcap)
    leaf_group = torch.arange(n_leaves) // k4.WL_GROUP
    assert int(leaf_hit.sum()) > origin.shape[0] // 2  # not vacuous
    assert not bool((leaf_hit & ~group_hit[:, leaf_group]).any())
    assert not bool(leaf_hit[nan].any() or group_hit[nan].any())
    # Some entries are -0.0 and some ceilings equal the entry, and those
    # rays still hit.
    tn, _ = k4._slab(lb, origin[:, None, :], safe_inv(direction)[:, None, :])
    neg_zero = (tn == 0) & torch.signbit(tn) & leaf_hit
    assert bool(neg_zero.any())
    assert bool((leaf_hit & (tn == tcap[:, None]) & (tcap[:, None] < BIG)).any())
    work.reset()
    k4.worklist_reference(origin, direction, alive, tcap, lb, EPSILON)
    assert work.WORK["group_misses"] == 0


def test_plain_version_counts_the_cull_and_ignores_the_groups():
    """The plain version's lists are the same whatever group boxes it is
    given (here boxes of the whole scene), and it counts the live rays'
    group tests, the leaves of the groups they enter and no miss."""
    lb = _boxes(300, 11)
    origin, direction, alive, tcap, _ = _adversarial_rays(lb)
    work.reset()
    wl = k4.worklist_reference(origin, direction, alive, tcap, lb, EPSILON)
    counted = dict(work.WORK)
    everything = torch.cat([lb[0:3].amin(dim=1), lb[3:6].amax(dim=1)])[:, None]
    wide = k4.worklist_reference(origin, direction, alive, tcap,
                                 _leaf_scene(lb, everything.expand(6, 10).contiguous()),
                                 EPSILON)
    for got, want in zip(wide, wl):
        assert torch.equal(got, want)
    n_live, G = int(alive.sum()), -(-300 // k4.WL_GROUP)
    assert counted["group_tests"] == n_live * G
    assert 0 < counted["group_leaf_tests"] < n_live * 300
    assert counted["group_misses"] == 0
    leaf_hit = _hits(lb, origin, direction, alive, tcap)
    assert counted["group_leaf_tests"] >= int(leaf_hit.sum())


@pytest.mark.parametrize("device,n_leaves,frustum", [
    (torch.device("cuda"), 84, False),
    (torch.device("cuda"), 2049, False),
    (torch.device("cuda"), 4336, False),
    (torch.device("cuda"), 16384, False),
    (torch.device("cuda"), 16385, False),
    (torch.device("cuda"), 163840, False),
    ("cuda:0", 4336, False),
    (torch.device("cpu"), 2048, False),
    (torch.device("cpu"), 2049, True),
    (torch.device("cpu"), 4336, True),
    (torch.device("cpu"), 163840, True),
])
def test_route(device, n_leaves, frustum):
    """The work-list kernel builds the exact lists on the card at every
    leaf count; the frustum pass runs on CPU tensors above
    FRUSTUM_LEAF_THRESHOLD, as in the JAX package."""
    assert k4.use_frustum_route(n_leaves, device) is frustum


def test_route_on_cpu_follows_the_threshold(monkeypatch):
    monkeypatch.setattr(k4, "FRUSTUM_LEAF_THRESHOLD", 0)
    assert k4.use_frustum_route(2, "cpu")
    assert not k4.use_frustum_route(2, "cuda")


def test_kernel_constants_are_the_modules():
    """csrc/worklist_kernel.cu's group width is WL_GROUP, and the kernel
    is one function, with no leaf limit and no second path below a cut."""
    text = (build.CSRC_DIR / "worklist_kernel.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert const("kGroup") == k4.WL_GROUP
    assert text.count("__global__") == 1 and "template <bool" not in text
    assert "kMaxLeaves" not in text and "kCullGroups" not in text


def _leaf_scene(lb, gb):
    """A LeafScene that carries only the leaf boxes `lb` and group boxes
    `gb`, all the work-list build reads of it."""
    return k4.LeafScene(leaf_bounds=lb, leaf_tiles=None, trih=None, root=None,
                        tile=0, leaf_count=None, aos=None, max_count=0,
                        chunk_bounds=None, group_bounds=gb)


def test_build_reads_the_group_boxes_of_its_leaf_scene(monkeypatch):
    """Given a LeafScene, build_worklist and worklist_reference count the
    cull on its own group boxes and derive none; given bare leaf boxes,
    they derive the groups, and both give the same lists."""
    lb = _boxes(300, 13)
    origin, direction, alive, tcap, _ = _adversarial_rays(lb)
    scene = _leaf_scene(lb, k4.group_bounds(lb))
    work.reset()
    bare = k4.build_worklist(origin, direction, alive, lb, EPSILON, tcap=tcap)
    derived = dict(work.WORK)
    derive = k4.group_bounds
    calls = []
    monkeypatch.setattr(k4, "group_bounds", lambda b: calls.append(b) or derive(b))
    work.reset()
    own = k4.build_worklist(origin, direction, alive, scene, EPSILON, tcap=tcap)
    assert dict(work.WORK) == derived and not calls
    for got, want in zip(own, bare):
        assert torch.equal(got, want)
    k4.worklist_reference(origin, direction, alive, tcap, lb, EPSILON)
    assert len(calls) == 1
