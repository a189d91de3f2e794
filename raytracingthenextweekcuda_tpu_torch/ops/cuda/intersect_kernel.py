"""Packed-scene container and its host packer (counterpart of
raytracingthenextweekcuda_tpu/ops/pallas/intersect_kernel.py:56-270).

The packed rows are planar (K, pad128) float32 arrays, padded with
never-hit columns, bit-equal to the reference's. The selection kernel that
reads them in the reference (intersect_packed) is not ported yet: see
ROADMAP.md, kernel K3.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

BIG = 3.0e38

TYPE_SPHERE = 1
TYPE_PLANE = 2
TYPE_TRIANGLE = 3


@dataclasses.dataclass(frozen=True)
class PackedScene:
    """Scene primitives packed into planar padded arrays.

    Base rows: spheres (10, Sp) cx0 cy0 cz0 dcx dcy dcz t0 inv_dt r pad;
    planes (13, Pp) pos(3) n(3) lo(3) hi(3) two_sided; triangles (9, Tp)
    v0(3) e1(3) e2(3). A shaded pack (bounce_kernel.pack_scene_shaded)
    appends 8 material rows to each and carries the Havel triangle/quad and
    oriented-box rows the render kernel reads.
    """

    spheres: np.ndarray
    planes: np.ndarray
    triangles: np.ndarray
    counts: tuple            # true (S, P, T)
    used_kinds: Optional[tuple] = None
    shaded: bool = False
    trih: Optional[np.ndarray] = None    # (20, Tp'): n(3) dc e1p(3) d1 e2p(3) d2 + mat(8)
    quadh: Optional[np.ndarray] = None   # (20, Qp): same rows, uv in [0,1]^2
    boxh: Optional[np.ndarray] = None    # (23, Bp): c(3) u(3) v(3) w(3) h(3) + mat(8)
    hcounts: tuple = (0, 0, 0)           # true (T', Q, B)
    has_emission: bool = True


def _pad128(n: int) -> int:
    return max(128, ((n + 127) // 128) * 128)


def pack_scene_host(scene) -> PackedScene:
    """Pack a scene's primitive arrays into planar padded rows (numpy)."""
    npf = np.float32

    sph = scene.spheres
    S = sph.count
    sp = np.zeros((10, _pad128(S)), npf)
    if S:
        c0 = np.asarray(sph.center0, npf)
        dc = np.asarray(sph.center1, npf) - c0
        t0 = np.asarray(sph.time0, npf)
        t1 = np.asarray(sph.time1, npf)
        sp[0:3, :S] = c0.T
        sp[3:6, :S] = dc.T
        sp[6, :S] = t0
        sp[7, :S] = npf(1.0) / (t1 - t0)
        sp[8, :S] = np.asarray(sph.radius, npf)
    # radius 0 in padding: the discriminant test never passes.

    pla = scene.planes
    P = pla.count
    pp = np.zeros((13, _pad128(P)), npf)
    if P:
        pos = np.asarray(pla.position, npf)
        ext = np.asarray(pla.extend, npf)
        lo = pos - ext
        hi = pos + ext
        # Only the two axes named by the orientation bound the plane:
        # XY -> z free, YZ -> x free, XZ -> y free.
        open_axis = np.asarray([2, 0, 1], np.int32)[np.asarray(pla.orientation)]
        is_open = np.arange(3)[None, :] == open_axis[:, None]
        lo = np.where(is_open, npf(-3e38), lo)
        hi = np.where(is_open, npf(3e38), hi)
        pp[0:3, :P] = pos.T
        pp[3:6, :P] = np.asarray(pla.normal, npf).T
        pp[6:9, :P] = lo.T
        pp[9:12, :P] = hi.T
        pp[12, :P] = np.asarray(pla.two_sided).astype(npf)
    # padding: normal 0, so the denominator gate fails.

    tri = scene.triangles
    T = tri.count
    tp = np.zeros((9, _pad128(T)), npf)
    if T:
        v = np.asarray(tri.vertices, npf)
        tp[0:3, :T] = v[:, 0].T
        tp[3:6, :T] = (v[:, 1] - v[:, 0]).T
        tp[6:9, :T] = (v[:, 2] - v[:, 0]).T

    kinds = np.asarray(scene.materials.kind)
    used_kinds = tuple(sorted({int(k) for k in kinds}))
    has_emission = bool(np.any(np.asarray(scene.materials.emission)))
    return PackedScene(sp, pp, tp, (S, P, T), used_kinds,
                       has_emission=has_emission)
