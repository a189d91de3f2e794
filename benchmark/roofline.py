"""Peaks of one NVIDIA H100 SXM and the work model of the render
kernel K1, the benchmark's own copy.

The peaks are NVIDIA's published figures (dense, at the 700 W limit):
3.35 TB/s of HBM, 67 TFLOP/s of float32 and 34 TFLOP/s of float64 outside
the tensor cores. The operation counts are those of one ray's test
against one primitive, and of one path-bounce's shading (the BSDF, the
pcg4d draws and the bookkeeping, whose square root, reciprocal square
root, sine and cosine run in float64), counted from the kernel's body.
The work a job needs is the live path-bounces it traces, which the
reference counts on its judged pixels: the same whatever code renders.
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12
FP64_OPS_S = 34e12

SPHERE_OPS = 40
PLANE_OPS = 34
TRIANGLE_OPS = 41      # a Havel triangle or quad column
BOX_OPS = 99           # an oriented box (12 triangles of a cube)
SHADE_OPS = 100
SHADE_F64_OPS = 80

# float32 rows a primitive occupies in K1's scene buffer, with its 8
# material rows.
SPHERE_ROWS, PLANE_ROWS, TRIANGLE_ROWS, BOX_ROWS = 18, 21, 20, 23


def primitive_counts(cfg: dict) -> dict:
    """Spheres, planes, boxes and loose triangles of a configuration, from
    its data: a mesh marked `box` is one oriented box."""
    from benchmark import scenedata

    prims = cfg["scene"]["primitives"]
    boxes = sum(1 for p in prims if p["type"] == "mesh" and p.get("box"))
    loose = sum(v.shape[0] for (v, _), p in
                zip(scenedata.scene_meshes(cfg), [p for p in prims if p["type"] == "mesh"])
                if not p.get("box"))
    return {"spheres": sum(p["type"] == "sphere" for p in prims),
            "planes": sum(p["type"] == "plane" for p in prims),
            "boxes": boxes, "triangles": loose}


def k1_bound_s(cfg: dict, path_bounces: float, pixels: int, samples: int) -> float:
    """The least time K1 could take for an image: the larger of its bytes
    (the scene, the frame, the sample key words and the pixel ids in, the
    radiance out) over the HBM rate and its operations over the peak rates."""
    c = primitive_counts(cfg)
    per = (SPHERE_OPS * c["spheres"] + PLANE_OPS * c["planes"]
           + BOX_OPS * c["boxes"] + TRIANGLE_OPS * c["triangles"] + SHADE_OPS)
    t_ops = path_bounces * per / FP32_OPS_S + path_bounces * SHADE_F64_OPS / FP64_OPS_S
    nbytes = 4 * (SPHERE_ROWS * c["spheres"] + PLANE_ROWS * c["planes"]
                  + BOX_ROWS * c["boxes"] + TRIANGLE_ROWS * c["triangles"])
    nbytes += 84 + samples * 8 + pixels * 4 + pixels * 12
    return max(nbytes / HBM_BYTES_S, t_ops)
