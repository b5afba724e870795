"""The plain reference of what the timed path computes: the suite's tracer.

Plain PyTorch, independent of the program: it imports nothing of it and
takes only the inputs the benchmark made (spheres, camera vectors, the
image cotangent's target).  It follows the suite's scalar code
(athas/raytracers ``futhark/ray.fut:32-168``):

* primary ray (i, j) through u = i / w, v = (h - j) / h;
* the closest hit over every sphere (no acceleration structure, which
  cannot change the winner), t in the open interval (0.1, 1e9), near root
  first, ties to the lower sphere index;
* shading re-intersects the winner in (0, t + 1), reflects the normalised
  direction about the normal, and absorbs where the reflection points
  into the sphere; a miss takes the light times the sky's gradient, a path
  alive at the depth cap stays black;
* each channel packs as int(255.99 c) into 0x00RRGGBB.

It runs in blocks of rays, only the rays still alive at each bounce, so
that it fits beside nothing else once the program's state is freed.
``dtype`` is the precision of every operation: float32 is the
configuration's; bfloat16 is the control that has to fail.

``trace`` also records each ray's path (the winner and event of every
bounce), which ``replay`` differentiates with autograd: the gradient of the
colours with the discrete path held fixed.
"""
from __future__ import annotations

import torch

EPS = 0.1        # t_min of the closest-hit search (ray.fut:3)
T_MAX = 1e9      # t_max (ray.fut:130)
SKY = (0.5, 0.7, 1.0)
# (ray, sphere) pairs a block of the closest-hit search holds, and rays a
# block of the replay holds: a few GB of temporaries on the card
BLOCK_PAIRS = 1 << 26
BLOCK_RAYS = 1 << 20
# events of a (bounce, ray) in a recorded path
BOUNCE, ABSORB, MISS, DEAD = 0, 1, 2, 3


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """IEEE square root in x's precision (through float64 for float32 on
    the host, where torch's float32 sqrt is not correctly rounded)."""
    if x.dtype == torch.float32 and x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _normalise(v):
    return v * (1.0 / _sqrt(_dot(v, v)))[..., None]


def primary_rays(cam, width: int, height: int, rows=None):
    """Origins and directions (R, 3) of the primary rays, row-major, or of
    the pixel rows ``rows`` (a range) only."""
    origin, llc, hor, ver = cam
    dev, dt = llc.device, llc.dtype
    rows = range(height) if rows is None else rows
    i = torch.arange(width, device=dev, dtype=dt)
    j = torch.arange(rows.start, rows.stop, device=dev, dtype=dt)
    u = i / torch.full_like(i, width)
    v = (height - j) / torch.full_like(j, height)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    d = (llc + uu.reshape(-1, 1) * hor + vv.reshape(-1, 1) * ver) - origin
    return origin.expand(d.shape), d


def _hit_t(ox, oy, oz, dx, dy, dz, cx, cy, cz, r, t_min, t_max):
    """The suite's ray-sphere parameter, broadcasting: near root first,
    else the far one, in the open interval (t_min, t_max); +inf on a miss.
    ``t_max`` may be a tensor."""
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    a = dx * dx + dy * dy + dz * dz
    b = ocx * dx + ocy * dy + ocz * dz
    c = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    disc = b * b - a * c
    pos = disc > 0
    sq = _sqrt(torch.where(pos, disc, torch.ones_like(disc)))
    r0 = (-b - sq) / a
    r1 = (-b + sq) / a
    inf = torch.full_like(r0, float("inf"))
    t = torch.where((r0 < t_max) & (r0 > t_min), r0,
                    torch.where((r1 < t_max) & (r1 > t_min), r1, inf))
    return torch.where(pos, t, inf)


def closest_hit(o, d, centre, radius):
    """(winner (R,) int64, -1 on a miss; t (R,)) over every sphere, in
    blocks of at most ``BLOCK_PAIRS`` (ray, sphere) pairs."""
    n = centre.shape[0]
    cx, cy, cz = (centre[:, k][None] for k in range(3))
    r = radius[None]
    step = max(1, BLOCK_PAIRS // n)
    idx, ts = [], []
    for s in range(0, o.shape[0], step):
        ob, db = o[s:s + step], d[s:s + step]
        t = _hit_t(ob[:, 0:1], ob[:, 1:2], ob[:, 2:3], db[:, 0:1],
                   db[:, 1:2], db[:, 2:3], cx, cy, cz, r, EPS, T_MAX)
        best, k = torch.min(t, dim=1)
        idx.append(torch.where(torch.isinf(best), -1, k))
        ts.append(best)
    return torch.cat(idx), torch.cat(ts)


def _sky(d):
    """The sky's gradient for direction d (ray.fut:141-148)."""
    t = 0.5 * (_normalise(d)[:, 1] + 1.0)
    sky = torch.tensor(SKY, dtype=d.dtype, device=d.device)
    return (1.0 - t)[:, None] + t[:, None] * sky


def _shade(o, d, c, r, t):
    """Hit point, normal and reflected direction of the winner (c, r)
    re-intersected in (0, t + 1) (ray.fut:40-45, 116-124)."""
    t2 = _hit_t(o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
                c[:, 0], c[:, 1], c[:, 2], r, 0.0, t + 1.0)
    p = o + t2[:, None] * d
    n = (p - c) * (1.0 / r)[:, None]
    v = _normalise(d)
    refl = v - (2.0 * _dot(v, n))[:, None] * n
    return p, n, refl


@torch.no_grad()
def trace(spheres, cam, width: int, height: int, max_depth: int,
          dtype=torch.float32, record: bool = False):
    """Colours (h, w, 3) in ``dtype`` and a dict: the segments each ray ran
    (``bounces``, (R,)), the work (``pixels``, ``spheres``, ``hits``,
    ``misses``: the segments that hit a sphere and that ended on the sky)
    and with ``record`` the ``path`` (winner (D, R) int32, event (D, R)
    uint8).  ``spheres`` and ``cam`` are cast to ``dtype``."""
    centre, radius, colour = (x.to(dtype) for x in spheres)
    cam = tuple(x.to(dtype) for x in cam)
    o, d = primary_rays(cam, width, height)
    R = o.shape[0]
    dev = o.device
    result = torch.zeros(R, 3, dtype=dtype, device=dev)
    light = torch.ones(R, 3, dtype=dtype, device=dev)
    alive = torch.arange(R, device=dev)
    bounces = torch.zeros(R, dtype=torch.int32, device=dev)
    if record:
        win = torch.full((max_depth, R), -1, dtype=torch.int32, device=dev)
        ev = torch.full((max_depth, R), DEAD, dtype=torch.uint8, device=dev)
    o, d = o.clone(), d.clone()
    misses = 0
    for depth in range(max_depth):
        if alive.numel() == 0:
            break
        oa, da = o[alive], d[alive]
        k, t = closest_hit(oa, da, centre, radius)
        bounces[alive] += 1
        hit = k >= 0
        ks = k.clamp(min=0)
        p, n, refl = _shade(oa, da, centre[ks], radius[ks], t)
        scatter = _dot(refl, n) > 0
        miss = ~hit
        bounce = hit & scatter
        la = light[alive]
        result[alive[miss]] = la[miss] * _sky(da[miss])
        misses += int(miss.sum())
        if record:
            win[depth, alive] = k.to(torch.int32)
            ev[depth, alive] = torch.where(
                miss, MISS, torch.where(scatter, BOUNCE, ABSORB)).to(
                    torch.uint8)
        keep = alive[bounce]
        o[keep], d[keep] = p[bounce], refl[bounce]
        light[keep] = la[bounce] * colour[ks[bounce]]
        alive = keep
    segments = int(bounces.sum(dtype=torch.int64))
    info = dict(bounces=bounces, pixels=R, spheres=centre.shape[0],
                hits=segments - misses, misses=misses)
    if record:
        info["path"] = (win, ev)
    return result.reshape(height, width, 3), info


def pack(colours: torch.Tensor) -> torch.Tensor:
    """(..., 3) colours -> packed int32 0x00RRGGBB, int(255.99 c) each."""
    q = (255.99 * colours.float()).to(torch.int32)
    return (q[..., 0] << 16) | (q[..., 1] << 8) | q[..., 2]


def conditioning(o, d, c, r):
    """disc / b² of each segment's sphere test, in float64: how far the
    discriminant b² - ac stands from the cancellation of its two terms."""
    o, d, c, r = (x.double() for x in (o, d, c, r))
    oc = o - c
    b = _dot(oc, d)
    disc = b * b - _dot(d, d) * (_dot(oc, oc) - r * r)
    return disc / (b * b).clamp_min(1e-300)


def replay(spheres, cam, width: int, height: int, path, cot,
           dtype=torch.float32, probe: dict | None = None):
    """Gradients of sum(colours * cot) with respect to the spheres'
    centre, radius, colour and the camera's origin, llc, horizontal,
    vertical, through the recorded ``path`` held fixed: autograd of the
    shading chain, in blocks of ``BLOCK_RAYS`` rays, each bounce over
    the rays still bouncing only.  A path that ends on the sky adds its
    colour times its cotangent; one absorbed or cut at the depth cap is
    black and adds nothing.  In ``dtype``, returned in float64.

    With ``probe`` (a dict) it also fills in, in float64, what each
    segment adds to the centre and radius gradients (``segment``: its
    sphere and pixel, centre (S, 3), radius (S,), ``conditioning``) and
    what each pixel adds to the camera's (``pixel``: ``grad`` (R, 12),
    origin, llc, horizontal, vertical, and ``conditioning``, the least of
    its path's), in the order the path sets, the same in every
    ``dtype``."""
    win, ev = path
    leaves = [x.detach().to(dtype).requires_grad_(True)
              for x in (*spheres, *cam)]
    centre, radius, colour = leaves[:3]
    grads = [torch.zeros_like(x, dtype=torch.float64) for x in leaves]
    cot = cot.to(dtype).reshape(-1, 3)
    R = width * height
    parts: dict = {k: [] for k in ("sphere", "seg_pixel", "centre",
                                   "radius", "seg_cond", "pixel",
                                   "pix_cond")}
    for start in range(0, R, BLOCK_RAYS):
        with torch.enable_grad():
            o, d = primary_rays(tuple(leaves[3:]), width, height)
            idx = torch.arange(start, min(R, start + BLOCK_RAYS),
                               device=o.device)
            o, d = o[idx], d[idx]
            extras = [o, d] if probe is not None else []
            pix = idx
            pix_cond = torch.full(idx.shape, float("inf"),
                                  dtype=torch.float64, device=o.device)
            light = torch.ones_like(o)
            loss = 0.0
            for s in range(win.shape[0]):
                if idx.numel() == 0:
                    break
                e = ev[s, idx]
                miss = e == MISS
                loss = loss + (light[miss] * _sky(d[miss])
                               * cot[idx[miss]]).sum()
                bounce = e == BOUNCE
                idx, o, d, light = idx[bounce], o[bounce], d[bounce], \
                    light[bounce]
                k = win[s, idx].long()
                c, r, col = centre[k], radius[k], colour[k]
                if probe is not None:
                    extras += [c, r]
                    cond = conditioning(o.detach(), d.detach(), c.detach(),
                                        r.detach())
                    parts["sphere"].append(k)
                    parts["seg_pixel"].append(idx)
                    parts["seg_cond"].append(cond)
                    at = idx - start
                    pix_cond[at] = torch.minimum(pix_cond[at], cond)
                with torch.no_grad():
                    t1 = _hit_t(o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1],
                                d[:, 2], c[:, 0], c[:, 1], c[:, 2], r, EPS,
                                T_MAX)
                    t1 = torch.where(torch.isfinite(t1), t1, 0.0)
                t2 = _hit_t(o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1],
                            d[:, 2], c[:, 0], c[:, 1], c[:, 2], r, 0.0,
                            t1 + 1.0)
                t2 = torch.where(torch.isfinite(t2), t2, 0.0)
                p = o + t2[:, None] * d
                n = (p - c) * (1.0 / r)[:, None]
                v = _normalise(d)
                o, d = p, v - (2.0 * _dot(v, n))[:, None] * n
                light = light * col
            g = torch.autograd.grad(loss, leaves + extras,
                                    allow_unused=True)
        for acc, gi in zip(grads, g):
            if gi is not None:
                acc += gi.double()
        if probe is not None:
            _probe_block(parts, extras, g[len(leaves):], pix, pix_cond,
                         width, height)
    if probe is not None:
        cat = {k: torch.cat(v) for k, v in parts.items()}
        probe["segment"] = dict(sphere=cat["sphere"], pixel=cat["seg_pixel"],
                                centre=cat["centre"], radius=cat["radius"],
                                conditioning=cat["seg_cond"])
        probe["pixel"] = dict(grad=cat["pixel"],
                              conditioning=cat["pix_cond"])
    return grads


def _probe_block(parts, extras, g, pix, pix_cond, width, height):
    """One block's share of ``replay``'s probe: each segment's centre and
    radius rows, each pixel's camera rows."""
    zero = lambda x, gx: (torch.zeros_like(x, dtype=torch.float64)
                          if gx is None else gx.double())
    do, dd = zero(extras[0], g[0]), zero(extras[1], g[1])
    for j in range(2, len(extras), 2):
        parts["centre"].append(zero(extras[j], g[j]))
        parts["radius"].append(zero(extras[j + 1], g[j + 1]))
    u = (pix % width).double() / width
    v = (height - torch.div(pix, width, rounding_mode="floor")).double() \
        / height
    parts["pixel"].append(torch.cat([do - dd, dd, u[:, None] * dd,
                                     v[:, None] * dd], 1))
    parts["pix_cond"].append(pix_cond)
