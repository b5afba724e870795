"""L1 geometry: spheres, ray-sphere / ray-AABB intersection, pinhole camera.

Counterpart of ``raytracers_tpu.geometry``.  Mask-based and broadcasting; a
miss is ``t = +inf``.  Semantics follow futhark/ray.fut:32-117 exactly as the
JAX package reproduces them (near-then-far root in an open interval, staged
slab test with the fail-if polarity, camera, reflection, sky gradient).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .vec import Aabb, cross, dot, normalise, sqrt
from .utils.platform import resolve_device

SCENE_EPSILON = 0.1     # t_min used for sphere tests inside traversal (ray.fut:3)
T_MIN = 0.0             # top-level t_min (ray.fut:130)
T_MAX = 1e9             # top-level t_max (ray.fut:130)
MAX_DEPTH = 50          # bounce limit (ray.fut:154)
INF = float("inf")


class Spheres(NamedTuple):
    """SoA sphere soup: center (N,3) f32, radius (N,) f32, color (N,3) f32."""
    center: torch.Tensor
    radius: torch.Tensor
    color: torch.Tensor

    @property
    def count(self) -> int:
        return self.center.shape[0]


def sphere_aabb(s: Spheres) -> Aabb:
    """Per-sphere AABBs: (N,3) min/max (futhark/ray.fut:28-30)."""
    r = s.radius[..., None]
    return Aabb(s.center - r, s.center + r)


def sphere_hit_t(origin, direction, center, radius, t_min, t_max):
    """Ray-sphere intersection parameter, broadcasting over any batch shape:
    ``t`` in the open interval (t_min, t_max), near root first, else +inf
    (futhark/ray.fut:32-51)."""
    oc = origin - center
    a = dot(direction, direction)
    b = dot(oc, direction)
    c = dot(oc, oc) - radius * radius
    disc = b * b - a * c
    pos = disc > 0.0
    sq = sqrt(torch.where(pos, disc, 1.0))
    root0 = (-b - sq) / a
    root1 = (-b + sq) / a
    ok0 = (root0 < t_max) & (root0 > t_min)
    ok1 = (root1 < t_max) & (root1 > t_min)
    t = torch.where(ok0, root0, torch.where(ok1, root1, INF))
    return torch.where(pos, t, INF)


def hit_record(t, origin, direction, center, radius, color):
    """Reconstruct (p, normal, colour) for a known hit t (ray.fut:40-45)."""
    p = origin + t[..., None] * direction
    normal = (p - center) * (1.0 / radius)[..., None]
    return p, normal, color


def aabb_hit(box: Aabb, origin, direction, t_min, t_max):
    """Slab test staged like futhark/ray.fut:53-70.  Each stage fails if
    ``tmax <= tmin``; a NaN stage (0 * inf for an axis-parallel ray whose
    origin lies on a slab plane) compares false and so reports a HIT.
    ``torch.minimum``/``maximum`` propagate NaN as XLA's min/max do."""
    def stage(lo, hi, o, d, tmin, tmax):
        inv = 1.0 / d
        t0 = (lo - o) * inv
        t1 = (hi - o) * inv
        near = torch.where(inv < 0.0, t1, t0)
        far = torch.where(inv < 0.0, t0, t1)
        tmin2 = torch.maximum(near, torch.as_tensor(tmin, dtype=near.dtype))
        tmax2 = torch.minimum(far, torch.as_tensor(tmax, dtype=far.dtype))
        return tmin2, tmax2, ~(tmax2 <= tmin2)

    tmin1, tmax1, ok1 = stage(box.min[..., 0], box.max[..., 0],
                              origin[..., 0], direction[..., 0], t_min, t_max)
    tmin2, tmax2, ok2 = stage(box.min[..., 1], box.max[..., 1],
                              origin[..., 1], direction[..., 1], tmin1, tmax1)
    _, _, ok3 = stage(box.min[..., 2], box.max[..., 2],
                      origin[..., 2], direction[..., 2], tmin2, tmax2)
    return ok1 & ok2 & ok3


class Camera(NamedTuple):
    """Pinhole camera (futhark/ray.fut:88-107): all fields (3,) f32."""
    origin: torch.Tensor
    llc: torch.Tensor
    horizontal: torch.Tensor
    vertical: torch.Tensor


def camera(look_from, look_at, vup, vfov_deg, aspect, device=None) -> Camera:
    """Camera of futhark/ray.fut:93-107.  The 12 floats are computed in
    float32 on the CPU, so they are the same whatever the target device,
    and then moved to ``device`` (default: the CUDA card)."""
    device = resolve_device(device)
    f32 = torch.float32
    look_from = torch.as_tensor(look_from, dtype=f32)
    look_at = torch.as_tensor(look_at, dtype=f32)
    vup = torch.as_tensor(vup, dtype=f32)
    theta = vfov_deg * math.pi / 180.0
    half_height = torch.tan(torch.tensor(theta / 2.0, dtype=f32))
    half_width = aspect * half_height
    w = normalise(look_from - look_at)
    u = normalise(cross(vup, w))
    v = cross(w, u)
    llc = look_from - half_width * u - half_height * v - w
    cam = Camera(origin=look_from, llc=llc,
                 horizontal=2.0 * half_width * u,
                 vertical=2.0 * half_height * v)
    return Camera(*(f.to(device) for f in cam))


def get_ray(cam: Camera, s, t):
    """Ray through film coordinates (s, t) (futhark/ray.fut:109-114):
    s, t batched (...,) -> origin (...,3), direction (...,3)."""
    d = (cam.llc + s[..., None] * cam.horizontal
         + t[..., None] * cam.vertical - cam.origin)
    return cam.origin.expand(d.shape), d


def reflect(v, n):
    """Mirror reflection (futhark/ray.fut:116-117)."""
    return v - 2.0 * dot(v, n)[..., None] * n


def sky_colour(direction):
    """Background gradient on miss (futhark/ray.fut:141-148)."""
    unit = normalise(direction)
    t = 0.5 * (unit[..., 1] + 1.0)
    white = torch.ones(3, dtype=direction.dtype, device=direction.device)
    bg = torch.tensor([0.5, 0.7, 1.0], dtype=direction.dtype,
                      device=direction.device)
    return (1.0 - t)[..., None] * white + t[..., None] * bg
