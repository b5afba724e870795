"""K3, the per-ray skip-link traversal render: scene tables, wrapper, plain
version, renders.

Counterpart of ``raytracers_tpu.render.pallas_traversal`` (the TPU kernel
``_kernel`` and its host-side glue).  Each ray walks its own skip-link BVH
(``bvh/lbvh.py``) over at most 128 clusters of K spheres:

    inner node:  slab test in (T_MIN, best_t) -> hit ? left child : skip
    leaf node:   the cluster's K spheres in (SCENE_EPSILON, best_t) -> skip

then shades its winner (a Whitted bounce: re-intersection in
(T_MIN, best_t + 1), mirror reflection, sky on a miss) and goes on until it
dies or reaches ``max_depth``.

* ``TraversalScene`` / ``build_traversal_scene`` lay the tables out exactly
  as the JAX package does, so the tests can hold them equal;
* ``traversal_kernel`` is the wrapper of the hand-written CUDA kernel
  (``csrc/traversal.cu``: persistent warps whose lanes take new rays, a
  ballot policy for leaf rounds, leaves split over the warp;
  ``traversal_model`` models the schedule); ``geometry_in_shared`` is its
  path rule.  On a CPU tensor it takes ``traversal_kernel_reference``, the
  plain torch version with the same per-ray arithmetic, which also counts
  each ray's work;
* ``render_traversal`` (one launch) and ``traversal_reference`` (the plain
  version through the same ray order) drive them.

K3's arithmetic is its own, not K1's: it searches in t space,
``t = (-b -+ sqrt(disc)) * (1/a)`` in the window ``eps < t < best_t`` with
a strictly smaller t winning (so the first visit wins a tie), and shades
with the window ``w_hi = best_t + 1``.  Each ray's visit sequence and
``best_t`` depend only on its own path, so the TPU kernel's per-tile
choice between a tree step and a leaf round (pallas_traversal.py:268-274)
changes nothing per ray: the plain version walks every ray each step, and
the kernel keeps the choice, per warp, for its time.  ``rsqrt(a)`` of the
TPU shading (pallas_traversal.py:326) is ``1/sqrt(a)``; square roots are
correctly rounded (``vec.sqrt``); min/max propagate NaN, so a NaN slab
stage keeps the node.
"""
from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple

import torch

from ..bvh.lbvh import build_bvh
from ..geometry import MAX_DEPTH, SCENE_EPSILON, T_MAX, T_MIN, Camera, Spheres
from ..utils import trace
from ..vec import sqrt
from .megakernel import _gen_rays, _ptr, _ray_order, _to_image, pack_pix
from .ray_math import sky

LANE = 128            # most clusters a scene may have
DEFAULT_TILE = 512
_BIG = float(T_MAX)
_DONE = -1.0
# per-ray counters of the plain version: inner-node slab tests, sphere slots
# tested, slots with a positive discriminant, far roots tried (the near
# root outside the window), bounces run, and bounces that ended on the sky
STATS = ("node_steps", "slot_tests", "slot_roots", "far_roots",
         "ray_bounces", "sky_bounces")
STEP_INNER, STEP_LEAF = 1, 2        # a walk step's kind in a trace
# the kernel's counters of a launch: warp rounds by kind (a tree step, a
# serial and a split leaf round, a shading), and the leaves tested in leaf
# rounds of each kind
COUNTERS = ("tree_steps", "serial_rounds", "split_rounds", "serial_leaves",
            "split_leaves", "shade_rounds")
# shared memory a block may opt into on sm_90 (227 KB), and the part the
# inner table and the leaf skips take
SMEM_LIMIT = 232_448
TABLE_SMEM = 9 * LANE * 4


class TraversalScene(NamedTuple):
    """Scene tables for K3 (pallas_traversal.py:52-65), lane dim 128.

    ``inner`` (8, 128) rows mnx mny mnz mxx mxy mxz left skip per inner node
    (ids as float32; C-1 valid lanes, padding +inf/-inf boxes and -1 ids);
    ``leaf_skip`` (1, 128) the skip link of each leaf; ``spheres``
    (K, 8, 128) row k holds slot k of every cluster, fields cx cy cz rad cr
    cg cb 0; ``order`` (C*K,) int32 the original sphere index, -1 padding.
    """
    inner: torch.Tensor
    leaf_skip: torch.Tensor
    spheres: torch.Tensor
    order: torch.Tensor


def build_traversal_scene(sph: Spheres, leaf_size: int | None = None):
    """Build the tables (pallas_traversal.py:68-113) on the device of
    ``sph``.  Returns (TraversalScene, C, K); the scene must fit in
    C <= 128 clusters of ``leaf_size`` (default max(8, ceil(n / 128)))."""
    n = sph.center.shape[0]
    if leaf_size is None:
        leaf_size = max(8, -(-n // LANE))
    C = -(-n // leaf_size)
    if C > LANE:
        raise ValueError(f"{C} clusters > 128; use the dense kernel")
    bvh = build_bvh(sph, leaf_size=leaf_size)
    C = bvh.n_leaves
    K = bvh.leaf_size
    n_inner = bvh.n_inner

    def pad_lane(x, fill=0.0):
        x = x.to(torch.float32)
        return torch.cat([x, x.new_full((LANE - x.shape[0],), fill)])

    inf = float("inf")
    inner = torch.stack([
        pad_lane(bvh.node_min[:, 0], inf),
        pad_lane(bvh.node_min[:, 1], inf),
        pad_lane(bvh.node_min[:, 2], inf),
        pad_lane(bvh.node_max[:, 0], -inf),
        pad_lane(bvh.node_max[:, 1], -inf),
        pad_lane(bvh.node_max[:, 2], -inf),
        pad_lane(bvh.left, _DONE),
        pad_lane(bvh.skip[:n_inner], _DONE),
    ])                                                    # (8, 128)
    leaf_skip = pad_lane(bvh.skip[n_inner:], _DONE)[None, :]  # (1, 128)

    s = bvh.spheres

    def sf(x):
        # (C*K,) -> (K, 128): row k holds slot k of every cluster
        x = x.reshape(C, K).T.to(torch.float32)
        return torch.cat([x, x.new_zeros(K, LANE - C)], dim=1)

    spheres = torch.stack([
        sf(s.center[:, 0]), sf(s.center[:, 1]), sf(s.center[:, 2]),
        sf(s.radius),
        sf(s.color[:, 0]), sf(s.color[:, 1]), sf(s.color[:, 2]),
        s.radius.new_zeros(K, LANE),
    ], dim=1)                                             # (K, 8, 128)
    scene = TraversalScene(inner=inner, leaf_skip=leaf_skip,
                           spheres=spheres.contiguous(), order=bvh.order)
    return scene, C, K


def _check(scene: TraversalScene, params, n_rays, tile, n_clusters,
           leaf_size, max_depth) -> None:
    dev = params.device
    if not 2 <= n_clusters <= LANE or leaf_size < 1:
        raise ValueError(f"{n_clusters} clusters of {leaf_size}: K3 takes "
                         f"2 to {LANE} clusters of at least one sphere")
    if max_depth < 0:
        raise ValueError(f"max_depth {max_depth} must be >= 0")
    if (params.dtype != torch.float32 or params.shape != (24,)
            or not params.is_contiguous()):
        raise ValueError("params must be a contiguous (24,) float32 tensor")
    if tile <= 0 or n_rays <= 0 or n_rays % tile:
        raise ValueError(f"n_rays {n_rays} must be a positive multiple of "
                         f"the tile {tile}")
    want = (("inner", scene.inner, (8, LANE)),
            ("leaf_skip", scene.leaf_skip, (1, LANE)),
            ("spheres", scene.spheres, (leaf_size, 8, LANE)))
    for name, t, shape in want:
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {dev}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape} tensor")


# ---------------------------------------------------------------------------
# the plain version


def _slab_step(inner, node, best_t, o, inv):
    """The staged slab test of each ray against its inner node's box in
    (T_MIN, best_t) (pallas_traversal.py:213-228): each stage fails on
    ``t_hi <= t_lo``; min/max propagate NaN, so a NaN stage passes."""
    t_lo = torch.full_like(best_t, T_MIN)
    t_hi = best_t
    ok = torch.ones_like(best_t, dtype=torch.bool)
    for k in range(3):
        t0 = (inner[k, node] - o[k]) * inv[k]
        t1 = (inner[3 + k, node] - o[k]) * inv[k]
        neg = inv[k] < 0.0
        t_lo = torch.maximum(torch.where(neg, t1, t0), t_lo)
        t_hi = torch.minimum(torch.where(neg, t0, t1), t_hi)
        ok = ok & ~(t_hi <= t_lo)
    return ok


def _slot_t(spheres, c, best_t, o, d, a, inv_a, far_root: bool):
    """Each ray's root of each slot of its leaf c in the window (eps,
    best_t), as ``sphere_t`` of the kernel computes it -> (t (m, K), BIG
    where none; disc > 0 (m, K); the near root (m, K))."""
    sx, sy, sz, sr = (spheres[:, f, c].T for f in range(4))      # (m, K)
    ox, oy, oz = (x[:, None] for x in o)
    dx, dy, dz = (x[:, None] for x in d)
    bt = best_t[:, None]
    ocx, ocy, ocz = ox - sx, oy - sy, oz - sz
    b = ocx * dx + ocy * dy + ocz * dz
    cc = ocx * ocx + ocy * ocy + ocz * ocz - sr * sr
    disc = b * b - a[:, None] * cc
    pos = disc > 0.0
    sq = sqrt(torch.where(pos, disc, 1.0))
    t0 = (-b - sq) * inv_a[:, None]
    ok0 = (t0 < bt) & (t0 > SCENE_EPSILON)
    if far_root:
        t1 = (-b + sq) * inv_a[:, None]
        ok1 = (t1 < bt) & (t1 > SCENE_EPSILON)
        t = torch.where(ok0, t0, torch.where(ok1, t1, _BIG))
    else:
        t = torch.where(ok0, t0, _BIG)
    return torch.where(pos, t, _BIG), pos, t0


def _leaf_round(spheres, c, best_t, o, d, a, inv_a, far_root: bool):
    """The K sphere tests of each ray's leaf c (pallas_traversal.py:233-
    266) -> (winner's t, its slot, improved, slots with disc > 0, far
    roots tried).  The kernel tests the slots in order, each in (eps, the
    running best): a slot's root in a smaller window is its root in the
    larger one if that lies inside, else none, so testing all in (eps,
    best_t at entry) and taking the first smallest gives the same winner
    and t, and the running best before slot k is the entry best lowered by
    the roots of slots 0..k-1."""
    r, pos, t0 = _slot_t(spheres, c, best_t, o, d, a, inv_a, far_root)
    bt = best_t[:, None]
    k_t, k_best = torch.min(r, dim=1)
    roots = pos.sum(dim=1, dtype=torch.int32)
    if far_root:
        run = torch.minimum(bt, torch.cummin(r, dim=1).values)
        win = torch.cat([bt, run[:, :-1]], dim=1)
        near = (t0 < win) & (t0 > SCENE_EPSILON)
        far = (pos & ~near).sum(dim=1, dtype=torch.int32)
    else:
        far = torch.zeros_like(roots)
    return k_t, k_best, k_t < best_t, roots, far


def _closest_hit(scene: TraversalScene, C: int, K: int, o, d, a,
                 far_root: bool, steps: list | None = None):
    """Each live ray's own walk (pallas_traversal.py:184-295): returns the
    winner's t (BIG on a miss), cluster and slot, and per ray (4, m) its
    node steps, sphere slots tested, slots with disc > 0 and far roots
    tried.  A preorder walk visits each of the 2C-1 nodes at most once.
    ``steps``, where given, gets each step's (m,) int8 kinds: 0 walk over,
    ``STEP_INNER`` or ``STEP_LEAF``."""
    NI = C - 1
    m = a.shape[0]
    dev = a.device
    inv_a = 1.0 / a
    inv = [1.0 / x for x in d]
    left, skip = scene.inner[6].long(), scene.inner[7].long()
    leaf_skip = scene.leaf_skip[0].long()
    cur = torch.zeros(m, dtype=torch.int64, device=dev)          # the root
    best_t = torch.full((m,), _BIG, dtype=torch.float32, device=dev)
    best_c = torch.zeros(m, dtype=torch.int64, device=dev)
    best_k = torch.zeros(m, dtype=torch.int64, device=dev)
    counts = torch.zeros(4, m, dtype=torch.int32, device=dev)
    for _ in range(2 * C - 1):
        walking = cur >= 0
        at_tree = (walking & (cur < NI)).nonzero().squeeze(1)
        at_leaf = (cur >= NI).nonzero().squeeze(1)
        if at_tree.numel() == 0 and at_leaf.numel() == 0:
            break
        if steps is not None:
            kind = torch.zeros(m, dtype=torch.int8, device=dev)
            kind[at_tree] = STEP_INNER
            kind[at_leaf] = STEP_LEAF
            steps.append(kind)
        if at_tree.numel():
            node = cur[at_tree]
            ok = _slab_step(scene.inner, node, best_t[at_tree],
                            [x[at_tree] for x in o],
                            [x[at_tree] for x in inv])
            cur[at_tree] = torch.where(ok, left[node], skip[node])
            counts[0, at_tree] += 1
        if at_leaf.numel():
            c = cur[at_leaf] - NI
            k_t, k_best, imp, roots, far = _leaf_round(
                scene.spheres, c, best_t[at_leaf],
                [x[at_leaf] for x in o], [x[at_leaf] for x in d],
                a[at_leaf], inv_a[at_leaf], far_root)
            best_t[at_leaf] = torch.where(imp, k_t, best_t[at_leaf])
            best_c[at_leaf] = torch.where(imp, c, best_c[at_leaf])
            best_k[at_leaf] = torch.where(imp, k_best, best_k[at_leaf])
            cur[at_leaf] = leaf_skip[c]
            counts[1, at_leaf] += K
            counts[2, at_leaf] += roots
            counts[3, at_leaf] += far
    return best_t, best_c, best_k, counts


def _shade(o, d, a, best_t, hit, sc, srad):
    """The winner's re-intersection in (T_MIN, best_t + 1) and its mirror
    shading (pallas_traversal.py:303-334) -> hit point, reflected
    direction, the unit direction's y and the scatter test."""
    ox, oy, oz = o
    dx, dy, dz = d
    scx, scy, scz = sc
    srad = torch.where(hit, srad, 1.0)
    ocx, ocy, ocz = ox - scx, oy - scy, oz - scz
    b = ocx * dx + ocy * dy + ocz * dz
    cc = ocx * ocx + ocy * ocy + ocz * ocz - srad * srad
    disc = b * b - a * cc
    sq = sqrt(torch.where(disc > 0.0, disc, 1.0))
    inv_a = 1.0 / a
    t0 = (-b - sq) * inv_a
    t1 = (-b + sq) * inv_a
    w_hi = best_t + 1.0
    t2 = torch.where((t0 < w_hi) & (t0 > T_MIN), t0, t1)
    px, py, pz = ox + t2 * dx, oy + t2 * dy, oz + t2 * dz
    inv_r = 1.0 / srad
    nx, ny, nz = (px - scx) * inv_r, (py - scy) * inv_r, (pz - scz) * inv_r
    inv_dn = 1.0 / sqrt(a)
    ux, uy, uz = dx * inv_dn, dy * inv_dn, dz * inv_dn
    udn = ux * nx + uy * ny + uz * nz
    rx = ux - 2.0 * udn * nx
    ry = uy - 2.0 * udn * ny
    rz = uz - 2.0 * udn * nz
    scatter = (rx * nx + ry * ny + rz * nz) > 0.0
    return (px, py, pz), (rx, ry, rz), uy, scatter


def traversal_kernel_reference(scene: TraversalScene, params: torch.Tensor,
                               n_rays: int, tile: int, *, n_clusters: int,
                               leaf_size: int, max_depth: int = MAX_DEPTH,
                               far_root: bool = True,
                               block_tiled: bool = False,
                               trace: list | None = None):
    """Plain torch version of K3, on any device, with the kernel's per-ray
    arithmetic.  Returns (packed (n_rays,) int32, stats (len(STATS),
    n_rays) int32): per ray the counters named in ``STATS``.  Bounces run
    over the live rays only, as the walk steps do.  ``trace``, where
    given, gets per bounce (the live rays' indices, the (steps, m) int8
    kinds of their walk steps), for ``traversal_model``."""
    _check(scene, params, n_rays, tile, n_clusters, leaf_size, max_depth)
    C, K = n_clusters, leaf_size
    dev = params.device
    S = _gen_rays(params, n_rays, tile, block_tiled)
    stats = torch.zeros(len(STATS), n_rays, dtype=torch.int32, device=dev)
    sph = scene.spheres
    for _ in range(max_depth):
        live = (S[12] > 0.0).nonzero().squeeze(1)
        if live.numel() == 0:
            break
        ox, oy, oz, dx, dy, dz, lr, lg, lb, rr, rg, rb = S[:12, live]
        o, d = (ox, oy, oz), (dx, dy, dz)
        a = dx * dx + dy * dy + dz * dz
        steps = None if trace is None else []
        best_t, best_c, best_k, counts = _closest_hit(
            scene, C, K, o, d, a, far_root, steps)
        if trace is not None:
            trace.append((live, torch.stack(steps) if steps else
                          torch.zeros(0, live.numel(), dtype=torch.int8)))
        hit = best_t < _BIG
        stats[:4, live] += counts
        stats[4, live] += 1
        stats[5, live] += (~hit).to(torch.int32)

        w = sph[best_k, :7, best_c]                              # (m, 7)
        w = torch.where(hit[:, None], w, 0.0)
        p, r, uy, scatter = _shade(o, d, a, best_t, hit, w[:, :3].unbind(1),
                                   w[:, 3])
        bnc = hit & scatter
        miss = ~hit
        tsky = 0.5 * (uy + 1.0)
        S[9, live] = torch.where(miss, lr * sky(tsky, 0.5), rr)
        S[10, live] = torch.where(miss, lg * sky(tsky, 0.7), rg)
        S[11, live] = torch.where(miss, lb * sky(tsky, 1.0), rb)
        S[6, live] = torch.where(bnc, lr * w[:, 4], lr)
        S[7, live] = torch.where(bnc, lg * w[:, 5], lg)
        S[8, live] = torch.where(bnc, lb * w[:, 6], lb)
        for k in range(3):
            S[k, live] = torch.where(bnc, p[k], o[k])
            S[3 + k, live] = torch.where(bnc, r[k], d[k])
        S[12, live] = bnc.to(torch.float32)
    return pack_pix(S[9], S[10], S[11]), stats


# ---------------------------------------------------------------------------
# the kernel's wrapper


def geometry_in_shared(n_clusters: int, leaf_size: int) -> bool:
    """The kernel's path for a scene: its geometry (cx, cy, cz, r of the
    C*K slots, 16 bytes each, cluster-major) in each block's shared memory
    where it fits beside the inner table and the leaf skips (irreg: 127 x
    79 slots, 160.5 KB), else read from global memory in the same layout."""
    return TABLE_SMEM + 16 * n_clusters * leaf_size <= SMEM_LIMIT


def cluster_major(scene: TraversalScene, n_clusters: int) -> torch.Tensor:
    """(C, K, 4) float32: slot k of cluster c as cx, cy, cz, r; the global
    path's geometry, one copy a launch."""
    return scene.spheres[:, :4, :n_clusters].permute(2, 0, 1).contiguous()


def traversal_kernel(scene: TraversalScene, params: torch.Tensor,
                     n_rays: int, tile: int, *, n_clusters: int,
                     leaf_size: int, max_depth: int = MAX_DEPTH,
                     far_root: bool = True, block_tiled: bool = False,
                     counters: torch.Tensor | None = None):
    """K3: render ``n_rays`` rays of the ray order in ``params`` (scanline
    or ``block_tiled``) to ``max_depth`` bounces -> packed (n_rays,) int32.

    A CPU tensor takes the plain version; a CUDA tensor launches the CUDA
    kernel on the current stream, without synchronising, and under
    ``utils.trace.counting()`` counts the launch in ``k3.launches`` by path
    (``shared`` or ``global``, the rule ``geometry_in_shared``).
    ``counters``, an int64 (len(COUNTERS),) tensor on the card, gets the
    launch's warp rounds added (the kernel's own; the plain version has no
    warps)."""
    _check(scene, params, n_rays, tile, n_clusters, leaf_size, max_depth)
    dev = params.device
    if counters is not None and (
            counters.device != dev or counters.dtype != torch.int64
            or tuple(counters.shape) != (len(COUNTERS),)
            or not counters.is_contiguous()):
        raise ValueError(f"counters must be a contiguous int64 "
                         f"({len(COUNTERS)},) tensor on {dev}")
    if dev.type == "cpu":
        if counters is not None:
            raise ValueError("counters count the kernel's warp rounds; "
                             "the plain version has none")
        return traversal_kernel_reference(
            scene, params, n_rays, tile, n_clusters=n_clusters,
            leaf_size=leaf_size, max_depth=max_depth, far_root=far_root,
            block_tiled=block_tiled)[0]
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    from . import _cuda
    fn = _cuda.load("traversal")
    shared = geometry_in_shared(n_clusters, leaf_size)
    geo = None if shared else cluster_major(scene, n_clusters)
    packed = torch.empty(n_rays, dtype=torch.int32, device=dev)
    work = torch.empty(1, dtype=torch.int32, device=dev)  # the ray counter
    rc = fn(_ptr(params), _ptr(scene.inner), _ptr(scene.leaf_skip),
            _ptr(scene.spheres), _ptr(geo), n_clusters, leaf_size,
            max_depth, int(far_root), _ptr(packed), n_rays, tile,
            int(block_tiled), _ptr(work), _ptr(counters),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError("traversal launch failed: "
                           + _cuda.error_string("traversal", rc))
    c = trace.counters()
    if c is not None:
        c.add("k3.launches", 1, "shared" if shared else "global")
    return packed


# ---------------------------------------------------------------------------
# renders


def render_traversal(scene: TraversalScene, n_clusters: int, leaf_size: int,
                     cam: Camera, width: int, height: int,
                     max_depth: int = MAX_DEPTH, tile: int = DEFAULT_TILE,
                     far_root: bool = True, block: tuple | None = (32, 16),
                     kernel: Callable = traversal_kernel):
    """Render -> packed int32 (h, w) with one K3 launch
    (pallas_traversal.py:377-425).  ``block=(bh, bw)`` with bh*bw == tile
    maps tiles to image rectangles, ``None`` to scanline runs; ``far_root``
    lets a sphere's far root count when its near root is outside the
    window.  ``kernel`` is what runs K3: the wrapper, or anything with its
    signature."""
    ro = _ray_order(cam, width, height, tile, block, 0.0, None, max_depth)
    out = kernel(scene, ro.params, ro.n_rays, tile, n_clusters=n_clusters,
                 leaf_size=leaf_size, max_depth=max_depth, far_root=far_root,
                 block_tiled=block is not None)
    return _to_image(ro, out, width, height)


def traversal_reference(scene: TraversalScene, n_clusters: int,
                        leaf_size: int, cam: Camera, width: int, height: int,
                        max_depth: int = MAX_DEPTH, tile: int = DEFAULT_TILE,
                        far_root: bool = True, block: tuple | None = (32, 16),
                        with_stats: bool = False):
    """``render_traversal`` through the plain version, on any device.  With
    ``with_stats`` it also returns the counters of ``STATS`` summed over
    the rays, and ``rays``, the rays run (the image's, padded to whole
    tiles)."""
    ro = _ray_order(cam, width, height, tile, block, 0.0, None, max_depth)
    out, stats = traversal_kernel_reference(
        scene, ro.params, ro.n_rays, tile, n_clusters=n_clusters,
        leaf_size=leaf_size, max_depth=max_depth, far_root=far_root,
        block_tiled=block is not None)
    img = _to_image(ro, out, width, height)
    if not with_stats:
        return img
    sums = stats.sum(dim=1, dtype=torch.int64).tolist()
    return img, dict(zip(STATS, sums), rays=ro.n_rays)
