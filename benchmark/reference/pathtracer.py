"""The plain reference renderer of the benchmark: a path tracer in plain
PyTorch that decides `correct`.

It follows the published semantics of the upstream renderer as the
program states them (jittered thin-lens camera, the pcg4d stream keyed by
(pixel, sample key words, bounce), the threefry key tree, sphere, plane
and back-face-culled triangle tests, eight material kinds, the sky, and
Russian roulette), and works everything out for itself from the
configuration's data: the camera frame, the pass and sample keys, the
triangles' plane rows. It has no acceleration structure and no packing:
every ray tests every primitive, the triangles one by one (a box is its
12 triangles). It imports nothing of the program.

Precision is an argument: `ft` is the arithmetic type (float32 as the
configuration states) and `fhi` the type of the square roots, sines,
cosines, exponentials and logarithms (float64, rounded to `ft`). The
control of the benchmark runs it with bfloat16 and float32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

EPSILON = 1e-3
FLT_EPSILON = 1.1920929e-7
TWO_PI = 6.283185307179586
SKY_WHITE = (1.0, 1.0, 1.0)
SKY_BLUE = (0.5, 0.7, 1.0)
LAMBERTIAN, METAL, DIELECTRIC, EMISSION = 0, 1, 2, 3
PHONG_METAL, SPECULAR, COAT, REFRACTION = 4, 5, 6, 7
RAYGEN_DOMAIN = 0x9E3779B9
RAYGEN_DOMAIN2 = 0x85EBCA6B
_MASK = 0xFFFFFFFF
# Elements of one (rays x primitives) block of the intersection tests.
_BLOCK = {"cpu": 1 << 23, "cuda": 1 << 24}


# -- the key tree: threefry2x32 as jax.random's default keys ------------------

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, d):
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(k1, k2, x1, x2):
    with np.errstate(over="ignore"):
        k1, k2 = np.uint32(k1), np.uint32(k2)
        ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
        x = [np.asarray(x1, np.uint32) + ks[0], np.asarray(x2, np.uint32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def key(seed: int) -> np.ndarray:
    return np.asarray([0, int(seed) & _MASK], np.uint32)


def fold_in(k: np.ndarray, data: int) -> np.ndarray:
    h0, h1 = threefry2x32(k[0], k[1], np.uint32(0), np.uint32(int(data) & _MASK))
    return np.asarray([h0, h1], np.uint32)


def split(k: np.ndarray, n: int) -> np.ndarray:
    counts = np.arange(n, dtype=np.uint32)
    h0, h1 = threefry2x32(k[0], k[1], np.zeros_like(counts), counts)
    return np.stack([h0, h1], axis=-1)


def passes(spp: int, spp_per_pass: int) -> list[int]:
    """Samples of each pass of an offline render."""
    chunk = spp_per_pass if spp_per_pass > 0 else spp
    chunk = max(1, min(chunk, spp))
    out = [chunk] * (spp // chunk)
    if spp % chunk:
        out.append(spp % chunk)
    return out


def render_sample_words(seed: int, spp: int, spp_per_pass: int) -> np.ndarray:
    """(spp, 2) key words of every sample of an offline render, pass after
    pass: split(fold_in(key(seed), pass), samples of the pass)."""
    k = key(seed)
    return np.concatenate([split(fold_in(k, i), n)
                           for i, n in enumerate(passes(spp, spp_per_pass))])


# -- the per-ray stream: pcg4d on uint32 words carried in int64 ---------------

def _mix(a, b, c, d):
    a = (a + b * d) & _MASK
    b = (b + c * a) & _MASK
    c = (c + a * b) & _MASK
    d = (d + b * c) & _MASK
    return a, b, c, d


def pcg4d(a, b, c, d):
    a, b, c, d = torch.broadcast_tensors(
        *(torch.as_tensor(v, device=a.device).to(torch.int64) & _MASK
          for v in (a, b, c, d)))
    a, b, c, d = ((v * 1664525 + 1013904223) & _MASK for v in (a, b, c, d))
    a, b, c, d = _mix(a, b, c, d)
    a, b, c, d = (v ^ (v >> 16) for v in (a, b, c, d))
    return _mix(a, b, c, d)


# -- the scene ---------------------------------------------------------------

@dataclasses.dataclass
class RefScene:
    """The configuration's primitives as the reference tests them, on one
    device in one arithmetic type."""

    sph: dict
    pla: dict
    tri: dict
    mat: dict
    kinds: set
    additive: bool


def _plane_rows(p):
    pos = np.asarray(p["position"], np.float32)
    ext = np.asarray(p["extend"], np.float32)
    lo, hi = pos - ext, pos + ext
    free = {"xy": 2, "yz": 0, "xz": 1}[p["orientation"]]
    lo[free], hi[free] = np.float32(-3e38), np.float32(3e38)
    return pos, np.asarray(p["normal"], np.float32), lo, hi


def _triangle_rows(verts):
    """Each triangle's unit normal, plane offset and the two edge planes
    that give its barycentric coordinates, in float32."""
    v0 = verts[:, 0]
    e1, e2 = verts[:, 1] - v0, verts[:, 2] - v0
    n = np.cross(e1, e2)
    nn = np.maximum((n * n).sum(-1, keepdims=True), np.float32(1e-30))
    nu = n / np.sqrt(nn)
    e1p = np.cross(e2, n) / nn
    e2p = np.cross(n, e1) / nn
    return dict(n=nu, dc=(nu * v0).sum(-1), e1p=e1p, d1=-(e1p * v0).sum(-1),
                e2p=e2p, d2=-(e2p * v0).sum(-1))


def build_scene(cfg: dict, meshes, device, ft=torch.float32) -> RefScene:
    """The reference's scene from a configuration's data (`cfg["scene"]`)
    and its mesh vertices (`meshes`: (vertices, material) in file order)."""
    sc = cfg["scene"]
    kinds = {"lambertian": 0, "metal": 1, "dielectric": 2, "emission": 3,
             "phong_metal": 4, "specular": 5, "coat": 6, "refraction": 7}
    m_rows = sc["materials"]
    size = max(int(m["id"]) for m in m_rows) + 1
    kind = np.zeros(size, np.int64)
    albedo = np.zeros((size, 3), np.float32)
    param = np.zeros(size, np.float32)
    emis = np.zeros((size, 3), np.float32)
    for m in m_rows:
        i = int(m["id"])
        kind[i] = kinds[m["kind"]]
        albedo[i] = m.get("albedo", (0.0, 0.0, 0.0))
        param[i] = m.get("param", 0.0)
        emis[i] = m.get("emission", (0.0, 0.0, 0.0))

    def t(x, dtype=None):
        return torch.as_tensor(np.asarray(x), device=device,
                               dtype=dtype or ft)

    sph = [p for p in sc["primitives"] if p["type"] == "sphere"]
    c0 = np.asarray([p["center0"] for p in sph], np.float32).reshape(-1, 3)
    c1 = np.asarray([p.get("center1", p["center0"]) for p in sph],
                    np.float32).reshape(-1, 3)
    t0 = np.asarray([p.get("time0", 0.0) for p in sph], np.float32)
    t1 = np.asarray([p.get("time1", 1.0) for p in sph], np.float32)
    t1 = np.where(t1 == t0, t0 + np.float32(1.0), t1)
    spheres = dict(c0=t(c0), dc=t(c1 - c0), t0=t(t0),
                   inv_dt=t(np.float32(1.0) / (t1 - t0)),
                   r=t(np.asarray([p["radius"] for p in sph], np.float32)),
                   mat=t([p["material"] for p in sph], torch.int64))

    pla = [_plane_rows(p) for p in sc["primitives"] if p["type"] == "plane"]
    pla_src = [p for p in sc["primitives"] if p["type"] == "plane"]
    planes = dict(
        pos=t(np.asarray([r[0] for r in pla], np.float32).reshape(-1, 3)),
        n=t(np.asarray([r[1] for r in pla], np.float32).reshape(-1, 3)),
        lo=t(np.asarray([r[2] for r in pla], np.float32).reshape(-1, 3)),
        hi=t(np.asarray([r[3] for r in pla], np.float32).reshape(-1, 3)),
        two=t([bool(p.get("two_sided", True)) for p in pla_src], torch.bool),
        mat=t([p["material"] for p in pla_src], torch.int64))

    verts = (np.concatenate([v for v, _ in meshes]) if meshes
             else np.zeros((0, 3, 3), np.float32))
    mids = (np.concatenate([np.full(v.shape[0], m, np.int64) for v, m in meshes])
            if meshes else np.zeros(0, np.int64))
    rows = _triangle_rows(verts.astype(np.float32))
    tris = {k: t(v) for k, v in rows.items()}
    tris["mat"] = t(mids, torch.int64)

    materials = dict(kind=t(kind, torch.int64), albedo=t(albedo),
                     param=t(param), emis=t(emis))
    return RefScene(spheres, planes, tris, materials,
                    {int(kind[int(m["id"])]) for m in m_rows},
                    bool(np.any(emis)))


# -- the camera ----------------------------------------------------------------

def _f32(x) -> torch.Tensor:
    return torch.tensor(np.float32(x))


def _norm(v: torch.Tensor) -> torch.Tensor:
    p = v * v
    nsq = p[..., 0] + p[..., 1] + p[..., 2]
    pos = nsq > 0.0
    safe = torch.where(pos, nsq, torch.ones_like(nsq))
    inv = torch.where(pos, 1.0 / torch.sqrt(safe.double()).float(),
                      torch.zeros_like(nsq))
    return v * inv[..., None]


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def camera_from(cam: dict) -> dict:
    """A camera's parameters as float32 CPU tensors."""
    return dict(eye=torch.from_numpy(np.asarray(cam["eye"], np.float32)),
                center=torch.from_numpy(np.asarray(cam["center"], np.float32)),
                up=torch.from_numpy(np.asarray(cam.get("up", (0.0, 1.0, 0.0)),
                                               np.float32)),
                fov=_f32(cam["fov"]), aperture=_f32(cam["aperture"]),
                focus_distance=_f32(cam["focus_distance"]),
                time0=_f32(cam.get("time0", 0.0)), time1=_f32(cam.get("time1", 0.0)))


def frame_vector(cam: dict, aspect: float) -> torch.Tensor:
    """The thin-lens frame as 21 float32 values: origin, lower-left corner,
    horizontal, vertical, right, up, lens radius, shutter open and close."""
    half = cam["fov"] / 2.0
    scale = torch.tan((half * float(np.float32(np.pi / 180))).double()).float()
    vh = 2.0 * scale
    vw = vh * aspect
    fwd = _norm(cam["center"] - cam["eye"])
    right = _norm(_cross(fwd, cam["up"]))
    up = _cross(right, fwd)
    fd = cam["focus_distance"]
    horiz = vw * right * fd
    vert = vh * up * fd
    lower = cam["eye"] - horiz / 2.0 - vert / 2.0 + fwd * fd
    parts = [cam["eye"], lower, horiz, vert, right, up, cam["aperture"] / 2.0,
             cam["time0"], cam["time1"]]
    return torch.cat([torch.as_tensor(p, dtype=torch.float32).reshape(-1)
                      for p in parts])


# -- the tracer ------------------------------------------------------------------

class _Math:
    """Arithmetic in `ft` with the functions taken in `fhi`."""

    def __init__(self, ft, fhi):
        self.ft, self.fhi = ft, fhi

    def f(self, fn, x):
        return fn(x.to(self.fhi)).to(self.ft)

    def sqrt(self, x):
        return self.f(torch.sqrt, x)

    def rsqrt(self, x):
        return (1.0 / torch.sqrt(x.to(self.fhi))).to(self.ft)

    def uniform(self, h):
        return (h >> 8).to(torch.int32).to(self.ft) * (1.0 / 16777216.0)


def _raygen(m: _Math, pid, b0, b1, f, width, height):
    ft = m.ft
    xs = (pid % width).to(ft)
    ys = torch.div(pid, width, rounding_mode="floor").to(ft)
    h = pcg4d(pid, b0, RAYGEN_DOMAIN, b1)
    u0, u1, u2, u3 = (m.uniform(x) for x in h)
    u4 = m.uniform(pcg4d(pid, b0, RAYGEN_DOMAIN2, b1)[0])
    dxs = (xs + u0) / torch.full_like(xs, width - 1.0)
    dys = (ys + u1) / torch.full_like(ys, height - 1.0)
    r = m.sqrt(u2)
    phi = (TWO_PI * u3).to(m.fhi)
    disk_x = f[18] * r * torch.cos(phi).to(ft)
    disk_y = f[18] * r * torch.sin(phi).to(ft)
    o = [f[k] + disk_x * f[12 + k] + disk_y * f[15 + k] for k in range(3)]
    d = [f[3 + k] + dxs * f[6 + k] + dys * f[9 + k] - o[k] for k in range(3)]
    nsq = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    pos = nsq > 0.0
    inv = torch.where(pos, 1.0 / m.sqrt(torch.where(pos, nsq, torch.ones_like(nsq))),
                      torch.zeros_like(nsq))
    tm = u4 * (f[20] - f[19]) + f[19]
    return o, [x * inv for x in d], tm


def _closest(m: _Math, rs: RefScene, o, d, tm, tmin):
    """(t, normal (3 lists), material id) of each ray's closest hit; t is
    +inf and the material -1 on a miss."""
    n = o[0].shape[0]
    dev, ft = o[0].device, o[0].dtype
    inf = torch.tensor(float("inf"), dtype=ft, device=dev)
    best = torch.full((n,), float("inf"), dtype=ft, device=dev)
    kind = torch.full((n,), -1, dtype=torch.int64, device=dev)
    index = torch.zeros((n,), dtype=torch.int64, device=dev)

    def take(t_all, k):
        m, i = torch.min(t_all, dim=1)
        upd = m < best
        best.copy_(torch.where(upd, m, best))
        kind.copy_(torch.where(upd, torch.full_like(kind, k), kind))
        index.copy_(torch.where(upd, i, index))

    O = [x[:, None] for x in o]
    D = [x[:, None] for x in d]
    s = rs.sph
    if s["r"].numel():
        a = (d[0] * d[0] + d[1] * d[1] + d[2] * d[2])[:, None]
        w = (tm[:, None] - s["t0"]) * s["inv_dt"]
        c = [s["c0"][:, k] + s["dc"][:, k] * w for k in range(3)]
        oc = [O[k] - c[k] for k in range(3)]
        hb = oc[0] * D[0] + oc[1] * D[1] + oc[2] * D[2]
        cc = oc[0] * oc[0] + oc[1] * oc[1] + oc[2] * oc[2] - s["r"] * s["r"]
        disc = hb * hb - a * cc
        ok = disc > FLT_EPSILON
        sq = m.sqrt(torch.where(ok, disc, torch.ones_like(disc)))
        inv_a = 1.0 / a
        r0 = (-hb - sq) * inv_a
        r1 = (-hb + sq) * inv_a
        t = torch.where(r0 >= tmin, r0, r1)
        take(torch.where(ok & (t >= tmin), t, inf), 0)
    p = rs.pla
    if p["mat"].numel():
        nx, ny, nz = p["n"][:, 0], p["n"][:, 1], p["n"][:, 2]
        den = D[0] * nx + D[1] * ny + D[2] * nz
        gate = ((den.abs() > EPSILON) & p["two"]) | ((den > EPSILON) & ~p["two"])
        inv = 1.0 / torch.where(gate, den, torch.ones_like(den))
        t = ((p["pos"][:, 0] - O[0]) * nx + (p["pos"][:, 1] - O[1]) * ny
             + (p["pos"][:, 2] - O[2]) * nz) * inv
        h = [O[k] + t * D[k] for k in range(3)]
        inside = torch.ones_like(gate)
        for k in range(3):
            inside = inside & (h[k] > p["lo"][:, k]) & (h[k] < p["hi"][:, k])
        take(torch.where(gate & inside & (t >= tmin), t, inf), 1)
    tr = rs.tri
    ntri = tr["mat"].numel()
    if ntri:
        step = max(1, _BLOCK.get(dev.type, 1 << 23) // ntri)
        for lo in range(0, n, step):
            sl = slice(lo, lo + step)
            Os, Ds = [x[sl] for x in O], [x[sl] for x in D]
            nn = tr["n"]
            dn = Ds[0] * nn[:, 0] + Ds[1] * nn[:, 1] + Ds[2] * nn[:, 2]
            ok = dn < -FLT_EPSILON
            inv = 1.0 / torch.where(ok, dn, torch.ones_like(dn))
            t = (tr["dc"] - (Os[0] * nn[:, 0] + Os[1] * nn[:, 1]
                             + Os[2] * nn[:, 2])) * inv
            h = [Os[k] + t * Ds[k] for k in range(3)]
            e1, e2 = tr["e1p"], tr["e2p"]
            uu = e1[:, 0] * h[0] + e1[:, 1] * h[1] + e1[:, 2] * h[2] + tr["d1"]
            vv = e2[:, 0] * h[0] + e2[:, 1] * h[1] + e2[:, 2] * h[2] + tr["d2"]
            hit = ok & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0) & (t > tmin)
            m, i = torch.min(torch.where(hit, t, inf), dim=1)
            upd = m < best[sl]
            best[sl] = torch.where(upd, m, best[sl])
            kind[sl] = torch.where(upd, torch.full_like(i, 2), kind[sl])
            index[sl] = torch.where(upd, i, index[sl])

    zero = torch.zeros_like(best)
    nrm = [zero, zero, zero]
    mat = torch.full_like(kind, -1)
    if s["r"].numel():
        sel = kind == 0
        i = torch.where(sel, index, torch.zeros_like(index))
        w = (tm - s["t0"][i]) * s["inv_dt"][i]
        r = s["r"][i]
        inv_r = 1.0 / torch.where(r != 0.0, r, torch.ones_like(r))
        bt = torch.where(sel, best, zero)
        nk = [(o[k] + bt * d[k] - (s["c0"][i, k] + s["dc"][i, k] * w)) * inv_r
              for k in range(3)]
        nrm = [torch.where(sel, a, b) for a, b in zip(nk, nrm)]
        mat = torch.where(sel, s["mat"][i], mat)
    if p["mat"].numel():
        sel = kind == 1
        i = torch.where(sel, index, torch.zeros_like(index))
        nrm = [torch.where(sel, p["n"][i, k], nrm[k]) for k in range(3)]
        mat = torch.where(sel, p["mat"][i], mat)
    if ntri:
        sel = kind == 2
        i = torch.where(sel, index, torch.zeros_like(index))
        nrm = [torch.where(sel, tr["n"][i, k], nrm[k]) for k in range(3)]
        mat = torch.where(sel, tr["mat"][i], mat)
    return best, nrm, mat


def _bounce(m: _Math, rs: RefScene, ray, tp, rad, u, do_rr, opts):
    """One bounce of live rays: the advanced (ray, throughput, radiance)
    and the mask of the rays that go on."""
    ft = m.ft
    o, d, tm = ray
    u0, u1, u2, u3 = u
    best, nrm, mid = _closest(m, rs, o, d, tm, opts["tmin"])
    valid = mid >= 0
    midc = mid.clamp_min(0)
    mt = rs.mat
    kind = torch.where(valid, mt["kind"][midc], torch.full_like(mid, -1))
    alb = [mt["albedo"][midc, k] for k in range(3)]
    par = mt["param"][midc]
    emis = [mt["emis"][midc, k] for k in range(3)]
    dx, dy, dz = d

    def is_kind(k):
        return kind == k

    def where(c, a, b):
        a = a if torch.is_tensor(a) else torch.full_like(dx, a)
        b = b if torch.is_tensor(b) else torch.full_like(dx, b)
        return torch.where(c, a, b)

    d_dot_n = dx * nrm[0] + dy * nrm[1] + dz * nrm[2]
    front = d_dot_n < FLT_EPSILON
    sgn = where(front, 1.0, -1.0)
    nx, ny, nz = nrm[0] * sgn, nrm[1] * sgn, nrm[2] * sgn
    il = m.rsqrt(torch.clamp_min(dx * dx + dy * dy + dz * dz, 1e-30))
    ux, uy, uz = dx * il, dy * il, dz * il
    phi = TWO_PI * u1
    cphi, sphi = m.f(torch.cos, phi), m.f(torch.sin, phi)

    def azimuth(z):
        rr = m.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
        return rr * cphi, rr * sphi, z

    def unit(x, y, z):
        inv = m.rsqrt(torch.clamp_min(x * x + y * y + z * z, 1e-30))
        return x * inv, y * inv, z * inv

    def lobe(ax, ay, az, cos_t):
        s = where(az >= 0.0, 1.0, -1.0)
        a_ = -1.0 / (s + az)
        b = ax * ay * a_
        t0 = (1.0 + s * ax * ax * a_, s * b, -s * ax)
        t1 = (b, s + ay * ay * a_, -ay)
        sin_t = m.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
        cp, sp = cphi * sin_t, sphi * sin_t
        return tuple(t0[k] * cp + t1[k] * sp + (ax, ay, az)[k] * cos_t
                     for k in range(3))

    def pick(sel, g, cur):
        return [torch.where(sel, a, b) for a, b in zip(g, cur)]

    udn = ux * nx + uy * ny + uz * nz
    mirror = (ux - 2.0 * udn * nx, uy - 2.0 * udn * ny, uz - 2.0 * udn * nz)
    av = azimuth(1.0 - 2.0 * u0)
    if LAMBERTIAN in rs.kinds:
        lr = [nx + av[0], ny + av[1], nz + av[2]]
        nzero = (lr[0].abs() < 1e-8) & (lr[1].abs() < 1e-8) & (lr[2].abs() < 1e-8)
        sd = list(unit(*(torch.where(nzero, a, b) for a, b in zip((nx, ny, nz), lr))))
    else:
        sd = [nx, ny, nz]
    at = list(alb)
    scattered = ~is_kind(EMISSION)
    one = torch.ones_like(dx)
    if METAL in rs.kinds:
        fuzz = torch.clamp_max(par, 1.0)
        ballr = m.f(torch.exp, m.f(torch.log, torch.clamp_min(u2, 1e-12))
                    / torch.full_like(u2, 3.0))
        mr = [mirror[k] + fuzz * (av[k] * ballr) for k in range(3)]
        ok = (mr[0] * nx + mr[1] * ny + mr[2] * nz) > 0.0
        sel = is_kind(METAL)
        sd = pick(sel, unit(*(torch.where(ok, a, b) for a, b in zip(mr, mirror))), sd)
        okf = ok.to(ft)
        at = pick(sel, [c * okf for c in alb], at)
        scattered = scattered & ~(sel & ~ok)
    if DIELECTRIC in rs.kinds:
        sel = is_kind(DIELECTRIC)
        ior = where(sel & (par > 0.0), par, 1.5)
        eta = torch.where(front, 1.0 / ior, ior)
        cos_t = torch.clamp_max(-(ux * nx + uy * ny + uz * nz), 1.0)
        sin_t = m.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
        cannot = eta * sin_t > 1.0
        r0 = (1.0 - eta) / (1.0 + eta)
        r0 = r0 * r0
        omc = 1.0 - cos_t
        omc2 = omc * omc
        rp = r0 + (1.0 - r0) * omc2 * omc2 * omc
        choose = cannot | (rp > u2)
        pp = [eta * (ux + cos_t * nx), eta * (uy + cos_t * ny), eta * (uz + cos_t * nz)]
        k_ = 1.0 - (pp[0] * pp[0] + pp[1] * pp[1] + pp[2] * pp[2])
        pos = k_ > 0.0
        rpar = where(pos, m.sqrt(where(pos, k_, 1.0)), 0.0)
        g = unit(*(torch.where(choose, mirror[k], pp[k] - rpar * (nx, ny, nz)[k])
                   for k in range(3)))
        sd = pick(sel, g, sd)
        at = pick(sel, (one, one, one), at)
    if PHONG_METAL in rs.kinds:
        sel = is_kind(PHONG_METAL)
        pc = m.f(torch.exp, m.f(torch.log, torch.clamp_min(u0, 1e-12))
                 / (torch.clamp_min(par, 0.0) + 1.0))
        sd = pick(sel, lobe(*unit(*mirror), pc), sd)
    if SPECULAR in rs.kinds:
        sd = pick(is_kind(SPECULAR), unit(*mirror), sd)
    if COAT in rs.kinds:
        sel = is_kind(COAT)
        spec = u2 < 0.05
        g = pick(spec, mirror, lobe(nx, ny, nz, m.sqrt(torch.clamp_min(1.0 - u0, 0.0))))
        sd = pick(sel, g, sd)
        specf = spec.to(ft)
        at = pick(sel, [specf + (1.0 - specf) * c for c in alb], at)
    if REFRACTION in rs.kinds:
        sel = is_kind(REFRACTION)
        nt = where(sel & (par > 0.0), par, 1.5)
        nnt = torch.where(front, 1.0 / nt, nt)
        ddn = ux * nx + uy * ny + uz * nz
        tir = (1.0 - nnt * nnt * (1.0 - ddn * ddn)) < 0.0
        cos_t = torch.clamp_max(-ddn, 1.0)
        pp = [nnt * (ux + cos_t * nx), nnt * (uy + cos_t * ny), nnt * (uz + cos_t * nz)]
        k_ = 1.0 - (pp[0] * pp[0] + pp[1] * pp[1] + pp[2] * pp[2])
        pos = k_ > 0.0
        rpar = where(pos, m.sqrt(where(pos, k_, 1.0)), 0.0)
        td = unit(*(pp[k] - rpar * (nx, ny, nz)[k] for k in range(3)))
        q = (nt - 1.0) / (nt + 1.0)
        r0 = q * q
        c1m = 1.0 - torch.where(front, -ddn, td[0] * nx + td[1] * ny + td[2] * nz)
        c1m2 = c1m * c1m
        re = r0 + (1.0 - r0) * c1m2 * c1m2 * c1m
        prob = 0.25 + 0.5 * re
        choose = tir | (u2 < prob)
        sd = pick(sel, pick(choose, unit(*mirror), td), sd)
        w = where(tir, 1.0, torch.where(choose, re / prob, (1.0 - re) / (1.0 - prob)))
        at = pick(sel, [c * w for c in alb], at)

    rad = list(rad)
    if opts["sky"]:
        t_sky = 0.5 * (uy + 1.0)
        missf = (~valid).to(ft)
        for k in range(3):
            sky = SKY_WHITE[k] + t_sky * float(np.float32(SKY_BLUE[k] - SKY_WHITE[k]))
            rad[k] = rad[k] + missf * tp[k] * sky
    if rs.additive:
        hitf = valid.to(ft)
        rad = [rad[k] + hitf * tp[k] * emis[k] for k in range(3)]
    if EMISSION in rs.kinds:
        termf = (valid & is_kind(EMISSION)).to(ft)
        rad = [rad[k] + termf * tp[k] * alb[k] * par for k in range(3)]
    cont = valid & scattered
    contf = cont.to(ft)
    ntp = [tp[k] * (1.0 - contf + contf * at[k]) for k in range(3)]
    if opts["russian_roulette"]:
        p = torch.clamp(torch.maximum(torch.maximum(ntp[0], ntp[1]), ntp[2]), 0.05, 1.0)
        survive = (u3 < p) if do_rr else torch.ones_like(cont)
        bf = (cont & survive).to(ft) if do_rr else torch.zeros_like(dx)
        inv_p = 1.0 / p
        ntp = [c * (1.0 - bf + bf * inv_p) for c in ntp]
        cont = cont & survive
    safe_t = where(valid, best, 0.0)
    new_o = [torch.where(cont, o[k] + safe_t * d[k], o[k]) for k in range(3)]
    new_d = [torch.where(cont, sd[k], d[k]) for k in range(3)]
    return (new_o, new_d, tm), ntp, rad, cont


def trace_pixels(rs: RefScene, frame: torch.Tensor, pixels: torch.Tensor,
                 words: np.ndarray, opts: dict, ft=torch.float32,
                 fhi=torch.float64, max_rays: int = 1 << 20):
    """Radiance of `pixels` (P,) summed over the samples whose key words
    are `words` (S, 2), in sample order: ((P, 3) in `ft`, live
    path-bounces traced). `opts`: width, height, bounces, tmin, sky,
    russian_roulette, rr_start."""
    m = _Math(ft, fhi)
    dev = pixels.device
    pixels = pixels.to(torch.int64)
    npix = pixels.shape[0]
    f = frame.to(device=dev, dtype=ft)
    words = np.asarray(words, np.uint32).reshape(-1, 2).astype(np.int64)
    accum = torch.zeros((npix, 3), dtype=ft, device=dev)
    per = max(1, max_rays // max(npix, 1))
    bounces_done = 0
    for s0 in range(0, words.shape[0], per):
        w = torch.from_numpy(words[s0: s0 + per]).to(dev)
        g = w.shape[0]
        pid = pixels.repeat(g)
        b0 = w[:, 0].repeat_interleave(npix)
        b1 = w[:, 1].repeat_interleave(npix)
        o, d, tm = _raygen(m, pid, b0, b1, f, opts["width"], opts["height"])
        n = pid.shape[0]
        tp = [torch.ones((n,), dtype=ft, device=dev) for _ in range(3)]
        rad = [torch.zeros((n,), dtype=ft, device=dev) for _ in range(3)]
        out = torch.zeros((n, 3), dtype=ft, device=dev)
        idx = torch.arange(n, device=dev)
        ray = (o, d, tm)
        for b in range(opts["bounces"]):
            if idx.numel() == 0:
                break
            bounces_done += idx.numel()
            h = pcg4d(pid[idx], b0[idx], b + 1, b1[idx])
            u = tuple(m.uniform(x) for x in h)
            ray, tp, rad, cont = _bounce(m, rs, ray, tp, rad, u,
                                         b >= opts["rr_start"], opts)
            done = ~cont
            out[idx[done]] = torch.stack(rad, dim=-1)[done]
            idx = idx[cont]
            ray = ([x[cont] for x in ray[0]], [x[cont] for x in ray[1]], ray[2][cont])
            tp = [x[cont] for x in tp]
            rad = [x[cont] for x in rad]
        if idx.numel():
            out[idx] = torch.stack(rad, dim=-1)
        out = out.reshape(g, npix, 3)
        for s in range(g):
            accum = accum + out[s]
    return accum, bounces_done


def film_mean(accum: torch.Tensor, samples: int) -> torch.Tensor:
    """The film's mean radiance: the sum times the float32 reciprocal of
    the sample count."""
    scale = np.float32(1.0) / np.float32(max(samples, 1))
    return accum * float(scale)


def tonemap_u8(mean: torch.Tensor) -> torch.Tensor:
    """255.99 * clamp(sqrt(c), 0, 0.999), truncated to u8."""
    c = torch.sqrt(torch.clamp_min(mean.float(), 0.0).double()).float()
    return (255.99 * torch.clamp(c, 0.0, 0.999)).to(torch.uint8)
