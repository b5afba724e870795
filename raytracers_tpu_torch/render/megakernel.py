"""The forward megakernel K1: scene layout, wrapper, plain version, renders.

Counterpart of ``raytracers_tpu.render.pallas_kernel`` (the TPU kernel
``_megakernel`` and its host-side glue) for the forward render path:

* ``PallasScene`` / ``build_pallas_scene`` lay the scene out exactly as the
  JAX package does (same tables, bit for bit), so the two packages render
  from the same data and the layout tests can hold them equal;
* ``megakernel`` is the wrapper of the hand-written CUDA kernel
  (``csrc/megakernel.cu``), which runs a ray on one thread or on one warp,
  the route that ``lanes_per_ray`` picks for the launch; on a CPU tensor it
  takes ``megakernel_reference``, the plain torch version with the same
  per-ray arithmetic;
* ``render_pallas`` (one launch) and ``render_pallas_twophase`` (phases with
  survivor-compaction sorts between them, then an unpermute sort) drive it;
* ``render_pallas_record`` and ``render_pallas_record_twophase`` drive its
  record mode (K1d): float colours plus, per step, each ray's winner slot
  and the winner's fields, which the backward replay (K2,
  ``grad/replay_bwd.py``) differentiates.

Every static mode of the JAX kernel is ported (K1f is the last of them):
clusters of 32, 64 or 128 spheres (``build_pallas_scene(cluster_width=)``;
winner slots stay ``cluster*128 + lane``), the near-root-only search
(``far_root=False``), the occlusion gate forced on at C <= 16
(``render_pallas_twophase(occl_cont=True)``), and ``lane_groups``.  JAX's
lane groups gate each group of a tile's rays on its own cull flags and
occlusion window (pallas_kernel.py:485-491); this port gates each ray alone,
which is the limit of that partition, so ``lane_groups`` is accepted and
validated (``_check_lane_groups``, which states JAX's fallback rule) and
changes nothing that the kernel computes.

Arithmetic shared by the kernel and the plain version, and why:

* the closest-hit search runs in m = a*t space with the packed key
  ``(bits(m) & ~0x7F) | lane``; clusters are swept in array order and the
  winner moves only on a strictly smaller key (pallas_kernel.py:646-710);
* culling and the occlusion gate act per ray, where the TPU gates a whole
  2048-ray tile; culling is conservative, so this changes no winner outside
  one 2^-16 key-floor bucket (pallas_kernel.py:712-724);
* ``rsqrt(a)`` of the TPU shading (pallas_kernel.py:920) is ``1/sqrt(a)``,
  two IEEE operations, as in the reference tracer's ``normalise``;
* min/max propagate NaN as XLA's do, so a NaN slab stage keeps a cluster;
* the visit's quadratic and the shading come from ``ray_math`` (the mirror
  of ``csrc/ray_math.cuh``), which K2's plain version shares.

``tile`` and ``block`` keep their JAX meaning as ray-order parameters: they
fix the padded ray count, the ray -> pixel map and the sort-prefix rounding,
so ray order and phase boundaries match the JAX package.  The CUDA launch
geometry is independent of them.
"""
from __future__ import annotations

import ctypes
import functools
import operator
import weakref
from collections import OrderedDict
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..bvh.lbvh import Clusters, build_clusters
from ..bvh.morton import morton3d
from ..geometry import MAX_DEPTH, SCENE_EPSILON, T_MAX, Camera, Spheres
from ..utils.trace import count, counters, counting, span, spanned, stats_on
from ..vec import sqrt
from .ray_math import bounce, quad, search_m, search_m_near, sky

LANE = 128            # lanes of the packed key and slots a cluster encodes
WIDTHS = (32, 64, LANE)   # sphere rows per cluster the kernel takes
DEFAULT_TILE = 512    # rays per tile of the ray order
_BIG = float(T_MAX)

_KEY_MASK = -LANE                                       # clears 7 low bits
_HIT_TH = int(np.float32(_BIG).view(np.int32)) & _KEY_MASK
_KRUN_INIT = _HIT_TH | (LANE - 1)

N_STATE = 13   # ox oy oz dx dy dz lr lg lb rr rg rb active
N_STATS = 3    # sphere rows tested, bounces run, AABB slab rows tested
STAT_NAMES = ("slot_tests", "ray_bounces", "cull_rows")
MAX_BLOCKS = 2048   # block unions the kernel holds in shared memory (48 KB)
LANES = (1, 32)     # lanes per ray of the kernel's two routes


class PallasScene(NamedTuple):
    """Scene laid out for the megakernel (pallas_kernel.py:80-114).

    C clusters of W Morton-sorted spheres (W = 32, 64 or 128); CB =
    ceil(C / CR) blocks of CR cull rows.  ``sphT`` (C,W,8) and ``sph8``
    (C,8,W) hold the fields cx cy cz rad cr cg cb r^2; ``aabbT`` (CB,CR,8)
    the cluster AABBs (padding clusters +inf/-inf); ``superT`` (1,SBR,8) the
    per-block unions; ``order`` (C,128) int32 the original sphere index of
    each slot ``cluster*128 + lane`` (-1 padding, and the lanes >= W);
    ``tailT``/``tail8`` the last cluster's first P rows, the peel of a
    partial final cluster (P == W: no partial cluster).
    """
    sphT: torch.Tensor
    sph8: torch.Tensor
    aabbT: torch.Tensor
    superT: torch.Tensor
    order: torch.Tensor
    tailT: torch.Tensor
    tail8: torch.Tensor

    @property
    def n_clusters(self) -> int:
        return self.sphT.shape[0]

    @property
    def cluster_width(self) -> int:
        return self.sphT.shape[1]


@spanned("rt.layout")
def build_pallas_scene(sph: Spheres, sort_origin=None,
                       cull_rows: int | None = None,
                       cluster_width: int | None = None) -> PallasScene:
    """Morton-sort and cluster the scene into the kernel layout
    (pallas_kernel.py:121-300).

    ``cluster_width`` W (default 128; 32 or 64) sets the sphere rows per
    cluster.  The winner slots stay ``cluster*128 + lane`` at any width
    (``order`` pads each cluster's row to 128 with -1), so the record and
    replay path is width-agnostic.  A scene of at most 128 spheres is one
    padded 128-row cluster, so W < 128 raises there, as the JAX package's
    reshape of that cluster does (pallas_kernel.py:165-192, 212).

    ``sort_origin`` (normally the camera origin) orders the clusters
    front-to-back by the distance of their AABB centres, within each block
    of CR clusters (and, for scene-scale layouts, the full blocks too), so
    the occlusion gate of C > 16 scenes prunes far clusters.  The argsorts
    are stable: irreg's grid is symmetric about its camera and many
    distances tie.  Scene-scale layouts (C > 128) take blocks of
    CR = ``cull_rows`` cull rows (default 64, rounded down to a multiple
    of 8 within [8, 128]), as the JAX package does; any CR gives the same
    image, since culling is conservative at any grouping.

    A CPU tensor takes the plain version, ``_build_pallas_scene_plain``; a
    CUDA tensor the two launches of ``csrc/layout.cu`` around one stable
    sort (``_build_pallas_scene_cuda``), which give the same tables bit for
    bit (a signed zero of ``aabbT`` or ``superT`` may differ in its sign
    alone).  The layout is built from the spheres on every call."""
    W = cluster_width or LANE
    if W not in WIDTHS:
        raise ValueError(f"cluster_width {W}: the kernel takes {WIDTHS}")
    n = sph.center.shape[0]
    if n <= LANE and W < LANE:
        raise ValueError(
            f"cluster_width {W} needs more than {LANE} spheres: a scene "
            f"of {n} is one padded {LANE}-row cluster (the JAX package "
            "fails to reshape it too)")
    dev = sph.center.device
    if dev.type == "cpu":
        return _build_pallas_scene_plain(sph, sort_origin, cull_rows, W)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _build_pallas_scene_cuda(sph, sort_origin, cull_rows, W)


def _cull_blocks(C: int, cull_rows: int | None) -> tuple:
    """(CR, CB, SBR): cull rows a block, blocks, and superT's rows."""
    CR = (max(8, -(-C // 8) * 8) if C <= LANE
          else max(8, min(LANE, cull_rows or 64) // 8 * 8))
    CB = -(-C // CR)
    return CR, CB, max(8, -(-CB // 8) * 8)


def _tail_rows(n: int, C: int, W: int, reordered: bool) -> int:
    """P, the rows of the tail peel: the partial last cluster's, rounded
    up to a power of two from 8, while that cluster is still last; else
    W (no peel)."""
    n_tail = n - (C - 1) * W
    if reordered or n_tail >= W:
        return W
    P = 8
    while P < n_tail:
        P *= 2
    return P


def _front_to_back(leaf_min, leaf_max, sort_origin, CR: int):
    """The clusters' front-to-back order: a stable argsort of their AABB
    centres' squared distances from ``sort_origin`` within each block of
    CR, and of the full blocks by their nearest cluster when there are two
    or more (the partial tail block stays last)."""
    C = leaf_min.shape[0]
    o = torch.tensor(sort_origin, dtype=torch.float32, device=leaf_min.device)
    d = 0.5 * (leaf_min + leaf_max) - o
    dist = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    segs = [b0 + torch.argsort(dist[b0:min(b0 + CR, C)], stable=True)
            for b0 in range(0, C, CR)]
    n_full = C // CR
    if n_full >= 2:
        blk_d = torch.stack([dist[b0:b0 + CR].amin()
                             for b0 in range(0, n_full * CR, CR)])
        border = torch.argsort(blk_d, stable=True)
        full = torch.stack(segs[:n_full])
        segs = [full[border].reshape(-1)] + segs[n_full:]
    return torch.cat(segs)


def _build_pallas_scene_plain(sph: Spheres, sort_origin, cull_rows,
                              W: int) -> PallasScene:
    """``build_pallas_scene`` in torch operations, on any device."""
    n = sph.center.shape[0]
    dev = sph.center.device
    if n <= LANE:
        # one cluster: pad with radius-0 spheres at the last real centre
        pad = LANE - n
        r = sph.radius[:, None]
        clusters = Clusters(
            spheres=Spheres(
                torch.cat([sph.center, sph.center[-1:].expand(pad, 3)]),
                torch.cat([sph.radius, sph.radius.new_zeros(pad)]),
                torch.cat([sph.color, sph.color.new_zeros(pad, 3)])),
            order=torch.cat([torch.arange(n, dtype=torch.int32, device=dev),
                             torch.full((pad,), -1, dtype=torch.int32,
                                        device=dev)]),
            leaf_min=(sph.center - r).amin(dim=0, keepdim=True),
            leaf_max=(sph.center + r).amax(dim=0, keepdim=True))
    else:
        clusters = build_clusters(sph, leaf_size=W)
    C = clusters.n_leaves
    s = clusters.spheres
    CR, CB, SBR = _cull_blocks(C, cull_rows)

    leaf_min, leaf_max = clusters.leaf_min, clusters.leaf_max
    order2d = clusters.order.reshape(C, W)
    perm = None
    if sort_origin is not None and C > 16:
        perm = _front_to_back(leaf_min, leaf_max, sort_origin, CR)
        leaf_min, leaf_max = leaf_min[perm], leaf_max[perm]
        order2d = order2d[perm]

    def field(x):
        x = x.reshape(C, W)
        return x if perm is None else x[perm]

    sph8 = torch.stack([
        field(s.center[:, 0]), field(s.center[:, 1]), field(s.center[:, 2]),
        field(s.radius),
        field(s.color[:, 0]), field(s.color[:, 1]), field(s.color[:, 2]),
        field(s.radius * s.radius),
    ], dim=1)                                             # (C, 8, W)
    sphT = sph8.transpose(1, 2).contiguous()              # (C, W, 8)

    pad = CB * CR - C
    inf = float("inf")

    def pad_clusters(x, fill):
        return torch.cat([x, x.new_full((pad,), fill)])

    aabbT = torch.stack([
        pad_clusters(leaf_min[:, 0], inf),
        pad_clusters(leaf_min[:, 1], inf),
        pad_clusters(leaf_min[:, 2], inf),
        pad_clusters(leaf_max[:, 0], -inf),
        pad_clusters(leaf_max[:, 1], -inf),
        pad_clusters(leaf_max[:, 2], -inf),
        leaf_min.new_zeros(CB * CR),
        leaf_min.new_zeros(CB * CR),
    ], dim=1).reshape(CB, CR, 8)

    blk_min = aabbT[:, :, 0:3].amin(dim=1)                # (CB, 3)
    blk_max = aabbT[:, :, 3:6].amax(dim=1)
    superT = torch.cat([
        torch.cat([blk_min, blk_min.new_full((SBR - CB, 3), inf)]),
        torch.cat([blk_max, blk_max.new_full((SBR - CB, 3), -inf)]),
        blk_min.new_zeros(SBR, 2),
    ], dim=1)[None]                                       # (1, SBR, 8)

    P = _tail_rows(n, C, W, perm is not None)
    if W < LANE:
        # slots stay cluster*128 + lane: pad each cluster's row to 128
        order2d = torch.cat([order2d, order2d.new_full((C, LANE - W), -1)],
                            dim=1)
    return PallasScene(sphT=sphT, sph8=sph8.contiguous(), aabbT=aabbT,
                       superT=superT, order=order2d,
                       tailT=sphT[C - 1, :P, :].contiguous(),
                       tail8=sph8[C - 1, :, :P].contiguous())


LAYOUT_MAX_BLOCKS = 256   # blocks of layout_codes, each leaving a partial


def _check_layout_input(sph: Spheres) -> None:
    """What ``csrc/layout.cu`` takes: contiguous float32 (n, 3) centres and
    colours and (n,) radii on one device, 1 <= n <= 2^26 (its int32
    offsets)."""
    n = sph.center.shape[0] if sph.center.dim() else 0
    want = {"center": (n, 3), "radius": (n,), "color": (n, 3)}
    for name, t in zip(Spheres._fields, sph):
        if (t.dtype != torch.float32 or tuple(t.shape) != want[name]
                or not t.is_contiguous() or t.device != sph.center.device):
            raise ValueError(
                f"spheres.{name} must be a contiguous float32 {want[name]} "
                f"tensor on {sph.center.device}: got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}, contiguous "
                f"{t.is_contiguous()}")
    if not 1 <= n <= 2 ** 26:
        raise ValueError(f"{n} spheres: the layout kernel takes 1 to 2^26")


def _build_pallas_scene_cuda(sph: Spheres, sort_origin, cull_rows,
                             W: int) -> PallasScene:
    """``build_pallas_scene`` on the card: ``layout_codes``, a stable sort
    of the codes, ``layout_pack``; with the front-to-back order, the pack
    again with the clusters' order (``_front_to_back`` on the first pack's
    boxes).  The seven tables are views of one buffer.  Under
    ``utils.trace.counting()`` each launch counts in ``layout.launches`` by
    stage (``codes``, ``pack``)."""
    from . import _cuda
    _check_layout_input(sph)
    fn = _cuda.load("layout")
    n = sph.center.shape[0]
    dev = sph.center.device
    C = 1 if n <= LANE else -(-n // W)
    CR, CB, SBR = _cull_blocks(C, cull_rows)
    reorder = sort_origin is not None and C > 16
    P = _tail_rows(n, C, W, reorder)
    sizes = (C * W * 8, C * 8 * W, CB * CR * 8, SBR * 8, C * LANE, P * 8,
             8 * P)
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    sphT, sph8, aabbT, superT, order, tailT, tail8 = flat.split(sizes)
    scene = PallasScene(
        sphT=sphT.view(C, W, 8), sph8=sph8.view(C, 8, W),
        aabbT=aabbT.view(CB, CR, 8), superT=superT.view(1, SBR, 8),
        order=order.view(torch.int32).view(C, LANE),
        tailT=tailT.view(P, 8), tail8=tail8.view(8, P))
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    c = counters()

    def launch(stage, perm=None, codes=None, partial=None, cperm=None):
        rc = fn(stage, *map(_ptr, (*sph, perm, cperm, codes, partial)),
                LAYOUT_MAX_BLOCKS, *map(_ptr, scene), n, C, W, CB, CR, SBR,
                P, int(n > LANE), stream)
        if rc != 0:
            raise RuntimeError("layout launch failed: "
                               + _cuda.error_string("layout", rc))
        if c is not None:
            c.add("layout.launches", 1, "pack" if stage else "codes")

    perm = None
    if n > LANE:
        scratch = torch.empty(n + LAYOUT_MAX_BLOCKS * 6, dtype=torch.int32,
                              device=dev)
        codes = scratch[:n]
        launch(0, codes=codes, partial=scratch[n:].view(torch.float32))
        perm = torch.sort(codes, stable=True)[1]
    launch(1, perm)
    if reorder:
        box = scene.aabbT.view(-1, 8)[:C]
        launch(1, perm, cperm=_front_to_back(box[:, 0:3], box[:, 3:6],
                                             sort_origin, CR))
    return scene


def _check_supported(scene: PallasScene) -> None:
    """What the kernel can hold: W-row clusters of a width it is built for,
    a tail of at most W rows, and at most MAX_BLOCKS block unions."""
    C, W = scene.n_clusters, scene.cluster_width
    if W not in WIDTHS or scene.sphT.shape != (C, W, 8):
        raise ValueError(f"sphT {tuple(scene.sphT.shape)}: the kernel takes "
                         f"(C, W, 8) with W in {WIDTHS}")
    if not 1 <= scene.tailT.shape[0] <= W:
        raise ValueError(f"tailT {tuple(scene.tailT.shape)}: a tail of 1 to "
                         f"{W} rows")
    if scene.aabbT.shape[0] > MAX_BLOCKS:
        raise ValueError(f"{scene.aabbT.shape[0]} cluster blocks: the kernel "
                         f"keeps at most {MAX_BLOCKS} block unions in shared "
                         "memory; raise cull_rows")


class _Flags(NamedTuple):
    cull: bool          # per-ray AABB culling of clusters
    occl: bool          # the occlusion gate
    two_level: bool     # block unions first, then the entered blocks' boxes
    tail_rows: int      # sphere rows of the last cluster (W: no peel)


def _kernel_flags(scene: PallasScene, cull: bool | None = None,
                  force_occl: bool = False) -> _Flags:
    """The TPU kernel's static choices (pallas_kernel.py:725, 789-791,
    1094-1095, 1402): culling for C > 1 unless ``cull`` says otherwise, the
    occlusion gate for culled C > 16 or when ``force_occl`` forces it, the
    two-level cull for culled layouts of more than one block, and the tail
    peel when P < 128 only for single-level sweeps of C <= 1024 (the TPU's
    sphere tables move to HBM beyond that); at W < 128 a full last cluster
    is so "peeled" at its W rows.  The peel is semantics, not only speed: a
    radius-0 padding row can register a hit (pallas_kernel.py:166-172)."""
    C = scene.n_clusters
    if cull is None:
        cull = C > 1
    two_level = cull and scene.aabbT.shape[0] > 1
    P = scene.tailT.shape[0]
    peel = P < LANE and C <= 1024 and not two_level
    return _Flags(cull, cull and (C > 16 or force_occl), two_level,
                  P if peel else scene.cluster_width)


def _check_lane_groups(lane_groups) -> None:
    """``lane_groups`` must be None or an integer >= 1.  A JAX launch runs
    that many groups only when it is culled, has one cull block, keeps its
    spheres resident (C <= 1024) and its tile splits into groups of whole
    128-lane rows, else one (pallas_kernel.py:1403-1416).  The port's kernel
    gates each ray alone, the limit of any such partition, so the count
    changes nothing it computes and is not resolved here."""
    if lane_groups is None:
        return
    if isinstance(lane_groups, bool):
        raise ValueError("lane_groups must be an integer >= 1, not a bool")
    try:
        ng = operator.index(lane_groups)
    except TypeError:
        raise ValueError(f"lane_groups {lane_groups!r} must be an integer "
                         ">= 1") from None
    if ng < 1:
        raise ValueError(f"lane_groups {ng} must be >= 1")


def _check_lanes(lanes) -> None:
    """``_lanes`` must be None (the route rule decides) or 1 or 32."""
    if lanes is None:
        return
    if isinstance(lanes, bool) or not isinstance(lanes, int) \
            or lanes not in LANES:
        raise ValueError(f"_lanes {lanes!r}: the kernel runs {LANES} lanes "
                         "per ray, or None for the route rule")


WARP_BELOW_RAYS = 2 ** 19   # generated launches this small take a warp per ray


def lanes_per_ray(n_rays: int, continuation: bool) -> int:
    """The route rule: the lanes per ray of a K1 launch of ``n_rays`` rays,
    generated or continuing from a state (``state_in`` given), from what the
    wrapper knows without reading the device.

    A warp per ray (32) for a continuation, whose survivors include the few
    rays that run long mirror chains while the rest are dead, and for fewer
    than ``WARP_BELOW_RAYS`` generated rays, which leave most of the card's
    lanes idle on a thread each (the 1M soup's 256x256 render: 65,536
    rays); a thread per ray (1) for the about one million generated rays of
    a 1000x1000 render, alike enough to fill the card.  The threshold lies
    between the largest generated launch measured faster on a warp per ray
    (the soup's 512x512 render, 262,144 rays) and the smallest measured
    faster on a thread (about 1M rays): any value between them routes every
    measured launch alike.  On the card (PERF.md §5) each launch of the main
    path runs on its faster route under this rule, or within the spread of
    two calls where the routes tie (irreg's K1d phase 0)."""
    return 32 if continuation or n_rays < WARP_BELOW_RAYS else 1


# ---------------------------------------------------------------------------
# the plain version


def _gen_rays(params: torch.Tensor, n_rays: int, tile: int,
              block_tiled: bool) -> torch.Tensor:
    """Primary-ray state (13, n) for the first n rays of the ray order
    (pallas_kernel.py:379-431): ray g is lane g % tile of tile g // tile,
    mapped to its pixel by scanline or by (bh, bw) image blocks.  Exact
    integer div/mod gives the values the TPU's f32 floor plus
    renormalisation gives."""
    p = params
    dev = p.device
    g = torch.arange(n_rays, device=dev)
    if block_tiled:
        bpr, bw, bh = (int(x) for x in p[20:23].tolist())
        pid, lid = g // tile, g % tile
        i = (pid % bpr) * bw + lid % bw
        j = (pid // bpr) * bh + lid // bw
    else:
        w = int(p[16].item())
        i, j = g % w, g // w
    i = i.to(torch.float32)
    j = j.to(torch.float32) + p[12]
    u = i * p[18]
    v = (p[17] - j) * p[19]
    d = [p[k] + u * p[3 + k] + v * p[6 + k] - p[9 + k] for k in range(3)]
    o = [p[9 + k].expand(n_rays) for k in range(3)]
    ones = torch.ones(n_rays, dtype=torch.float32, device=dev)
    zeros = torch.zeros_like(ones)
    return torch.stack(o + d + [ones, ones, ones, zeros, zeros, zeros, ones])


def _slab(box, ox, oy, oz, dx, dy, dz):
    """Slab test of each ray (m,) against each row (mn xyz, mx xyz) of an
    AABB table (k, 8): the entry distances lo (m, k) and whether the ray's
    [0, BIG) interval meets the box.  min/max propagate NaN, and the test
    fails only on ``hi <= lo``, so a NaN stage keeps the box."""
    lo = hi = None
    for k, (oo, dd) in enumerate(((ox, dx), (oy, dy), (oz, dz))):
        inv = (1.0 / dd)[:, None]
        t0 = (box[:, k] - oo[:, None]) * inv
        t1 = (box[:, 3 + k] - oo[:, None]) * inv
        alo, ahi = torch.minimum(t0, t1), torch.maximum(t0, t1)
        lo = alo if lo is None else torch.maximum(lo, alo)
        hi = ahi if hi is None else torch.minimum(hi, ahi)
    big = torch.tensor(_BIG, dtype=torch.float32, device=ox.device)
    zero = torch.zeros((), dtype=torch.float32, device=ox.device)
    return lo, ~(torch.minimum(hi, big) <= torch.maximum(lo, zero))


def _closest_hit_reference(scene: PallasScene, flags: _Flags, far_root: bool,
                           ox, oy, oz, dx, dy, dz, a):
    """Per-ray culled packed-key search over the live rays, over W-row
    clusters, with the far-root fallback unless ``far_root`` is False.

    Single-level (one cull block): every cluster's AABB, then the visit.
    Two-level (K1e, pallas_kernel.py:526-566, 796-838): each ray tests the
    CB block unions of ``superT``, and only in the blocks whose union it
    meets the blocks' cluster AABBs; clusters are visited in array order,
    block by block, behind the occlusion gate.  Padding clusters are never
    visited.  The work goes block by block, so no (m, C) tensor is made.

    Returns the winning key, the winner's cluster, and per ray the sphere
    rows tested and the AABB rows tested (``cull_rows``: C a bounce for a
    single-level sweep; CB super rows plus the clusters of each entered
    block for a two-level one)."""
    sphT = scene.sphT
    C, W = scene.n_clusters, scene.cluster_width
    CB, CR = scene.aabbT.shape[:2]
    search = search_m if far_root else search_m_near
    m = ox.shape[0]
    dev = ox.device
    krun = torch.full((m,), _KRUN_INIT, dtype=torch.int32, device=dev)
    wcl = torch.zeros(m, dtype=torch.int64, device=dev)
    slots = torch.zeros(m, dtype=torch.int32, device=dev)
    crows = torch.zeros(m, dtype=torch.int32, device=dev)
    lanes = torch.arange(W, dtype=torch.int32, device=dev)
    ray = (ox, oy, oz, dx, dy, dz)
    if flags.two_level:
        _, sup_ok = _slab(scene.superT[0, :CB], *ray)        # (m, CB)
        crows += CB
        blocks = [(b * CR, min(CR, C - b * CR),
                   sup_ok[:, b].nonzero().squeeze(1)) for b in range(CB)]
    else:
        if flags.cull:
            crows += C
        blocks = [(0, C, torch.arange(m, device=dev))]
    boxes = scene.aabbT.reshape(-1, 8)
    for c0, nb, ids in blocks:
        if ids.numel() == 0:
            continue
        if flags.two_level:
            crows[ids] += nb
        r = [x[ids] for x in ray]
        ab = a[ids]
        if flags.cull:
            lo, ok = _slab(boxes[c0:c0 + nb], *r)             # (mb, nb)
            visits = ok.any(dim=0).nonzero().squeeze(1).tolist()
        else:
            visits = range(nb)
        for j in visits:
            c = c0 + j
            rows = flags.tail_rows if c == C - 1 else W
            if flags.cull:
                keep = ok[:, j]
                if flags.occl:
                    best_f = (krun[ids] & _KEY_MASK).view(torch.float32)
                    keep = keep & ~(lo[:, j] * ab >= best_f)
                sel = keep.nonzero().squeeze(1)
                if sel.numel() == 0:
                    continue
                g = ids[sel]
                ro = [x[sel, None] for x in r] + [ab[sel, None]]
            else:
                g = ids
                ro = [x[:, None] for x in r] + [ab[:, None]]
            s = sphT[c, :rows]                               # (rows, 8)
            q = quad(*ro, s[:, 0], s[:, 1], s[:, 2], s[:, 7])
            tv = search(q, sqrt(q.disc), SCENE_EPSILON * ro[6])
            key = (tv.view(torch.int32) & _KEY_MASK) | lanes[:rows]
            kmin = key.amin(dim=1)
            cur = krun[g]
            imp = kmin < cur
            krun[g] = torch.where(imp, kmin, cur)
            wcl[g] = torch.where(imp, c, wcl[g])
            slots[g] += rows
    return krun, wcl, slots, crows


def megakernel_reference(scene: PallasScene, params: torch.Tensor,
                         n_rays: int, tile: int, *, block_tiled: bool = False,
                         state_in: torch.Tensor | None = None,
                         emit_state: bool = False, with_stats: bool = False,
                         record_depth: int | None = None,
                         record_pay: bool = False, cull: bool | None = None,
                         far_root: bool = True, force_occl: bool = False,
                         lane_groups: int | None = None):
    """Plain torch version of K1, on any device, with the kernel's per-ray
    arithmetic: square roots correctly rounded through float64, no fused
    multiply-adds.  Bounces run over the live rays only and each cluster
    over the rays its gates pass.  Same arguments and results as
    ``megakernel``."""
    _check_supported(scene)
    _check_lane_groups(lane_groups)
    flags = _kernel_flags(scene, cull, force_occl)
    W = scene.cluster_width
    dev = params.device
    S = (_gen_rays(params, n_rays, tile, block_tiled) if state_in is None
         else state_in.clone())
    stats = torch.zeros(N_STATS, n_rays, dtype=torch.int32, device=dev)
    rec = pay = None
    if record_depth is not None:
        depth_cap = record_depth
        rec = torch.full((record_depth, n_rays), -2, dtype=torch.int32,
                         device=dev)
        if record_pay:
            pay = torch.zeros(record_depth, 8, n_rays, dtype=torch.float32,
                              device=dev)
    else:
        depth_cap = int(params[13].item())
    for depth in range(depth_cap):
        live = (S[12] > 0.0).nonzero().squeeze(1)
        if live.numel() == 0:
            break
        ox, oy, oz, dx, dy, dz, lr, lg, lb, rr, rg, rb = S[:12, live]
        a = dx * dx + dy * dy + dz * dz
        krun, wcl, slots, crows = _closest_hit_reference(
            scene, flags, far_root, ox, oy, oz, dx, dy, dz, a)
        stats[0, live] += slots
        stats[1, live] += 1
        stats[2, live] += crows

        hit = krun < _HIT_TH
        lane = krun & (LANE - 1)
        # a hit's lane is < W; a miss's fields are read but never used
        w = scene.sphT[wcl, (lane & (W - 1)).long()]          # (m, 8)
        scx, scy, scz, srad, sr, sg, sb = w[:, :7].unbind(1)
        h = bounce(ox, oy, oz, dx, dy, dz, a, scx, scy, scz, srad,
                   (krun & _KEY_MASK).view(torch.float32))
        bnc = hit & h.scatter
        miss = ~hit
        if rec is not None:
            slot = (wcl * LANE + lane).to(torch.int32)
            rec[depth, live] = torch.where(
                miss, -1, torch.where(bnc, slot, -3)).to(torch.int32)
            if pay is not None:
                pay[depth][:7, live] = w[:, :7].T

        tsky = 0.5 * (h.uy + 1.0)
        S[9, live] = torch.where(miss, lr * sky(tsky, 0.5), rr)
        S[10, live] = torch.where(miss, lg * sky(tsky, 0.7), rg)
        S[11, live] = torch.where(miss, lb * sky(tsky, 1.0), rb)
        S[6, live] = torch.where(bnc, lr * sr, lr)
        S[7, live] = torch.where(bnc, lg * sg, lg)
        S[8, live] = torch.where(bnc, lb * sb, lb)
        S[0, live] = torch.where(bnc, h.px, ox)
        S[1, live] = torch.where(bnc, h.py, oy)
        S[2, live] = torch.where(bnc, h.pz, oz)
        S[3, live] = torch.where(bnc, h.rx, dx)
        S[4, live] = torch.where(bnc, h.ry, dy)
        S[5, live] = torch.where(bnc, h.rz, dz)
        S[12, live] = bnc.to(torch.float32)
    out = S if emit_state else pack_pix(S[9], S[10], S[11])
    if rec is not None:
        return out, (stats if with_stats else None), rec, pay
    return out, (stats if with_stats else None)


def pack_pix(rr, rg, rb):
    """255.99 quantization and packing (futhark/ray.fut:156-162)."""
    pr = (255.99 * rr).to(torch.int32)
    pg = (255.99 * rg).to(torch.int32)
    pb = (255.99 * rb).to(torch.int32)
    return (pr << 16) | (pg << 8) | pb


# ---------------------------------------------------------------------------
# the kernel's wrapper


def _check_launch(scene: PallasScene, params, n_rays, tile, block_tiled,
                  state_in, record_depth=None, record_pay=False,
                  lane_groups=None):
    dev = params.device
    if record_pay and record_depth is None:
        raise ValueError("record_pay needs record_depth")
    if record_depth is not None and record_depth < 1:
        raise ValueError(f"record_depth {record_depth} must be >= 1")
    _check_supported(scene)
    _check_lane_groups(lane_groups)
    if (params.dtype != torch.float32 or params.shape != (24,)
            or not params.is_contiguous()):
        raise ValueError("params must be a contiguous (24,) float32 tensor")
    if tile <= 0 or n_rays <= 0 or n_rays % tile:
        raise ValueError(f"n_rays {n_rays} must be a positive multiple of "
                         f"the tile {tile}")
    if n_rays * N_STATE >= 2 ** 31:
        raise ValueError(f"n_rays {n_rays} overflows the kernel's int32 "
                         "state offsets")
    if block_tiled and state_in is not None:
        raise ValueError("block tiles map generated rays; a continuation "
                         "takes its rays from state_in")
    for name, t in (("sphT", scene.sphT), ("aabbT", scene.aabbT),
                    ("superT", scene.superT), ("state_in", state_in)):
        if t is None:
            continue
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {dev}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if state_in is not None and state_in.shape != (N_STATE, n_rays):
        raise ValueError(f"state_in must be ({N_STATE}, {n_rays})")


def megakernel(scene: PallasScene, params: torch.Tensor, n_rays: int,
               tile: int, *, block_tiled: bool = False,
               state_in: torch.Tensor | None = None,
               emit_state: bool = False, with_stats: bool = False,
               record_depth: int | None = None, record_pay: bool = False,
               cull: bool | None = None, far_root: bool = True,
               force_occl: bool = False, lane_groups: int | None = None,
               _lanes: int | None = None):
    """K1: trace ``n_rays`` rays until they die or reach the depth cap
    ``params[13]``, over the layout's clusters of 32, 64 or 128 spheres.

    Rays are generated from the camera in ``params`` (mode K1a; scanline or
    ``block_tiled``) or continue from ``state_in`` (13, n_rays) (K1b).  The
    result is the packed int32 (n_rays,) image in ray order, or with
    ``emit_state`` the (13, n_rays) state; ``with_stats`` adds (3, n_rays)
    int32 per-ray counters (K1c): sphere rows tested, bounces run, AABB
    slab rows tested (``cull_rows``: per bounce C for a single-level
    sweep, and for a two-level one the CB block unions plus the cluster
    rows of each block whose union the ray meets).  Returns (out, stats or
    None).

    ``cull`` (default: C > 1) turns AABB culling on or off; the image is
    the same either way.  Layouts of more than one cull block (C > 128)
    take the two-level cull (K1e) when culled.  ``far_root=False`` searches
    the near root only (a ray inside a sphere then passes through it);
    ``force_occl`` turns the occlusion gate on at C <= 16 too; ``lane_groups``
    is checked (``_check_lane_groups``) and changes nothing here (K1f).

    ``record_depth=D`` (K1d) makes D the depth cap instead of ``params[13]``
    and adds the path record: returns (out, stats, rec, pay) with ``rec``
    (D, n_rays) int32, per step the winner slot ``cluster*128 + lane`` of a
    mirror bounce, -1 a miss, -3 an absorbed hit, -2 a step after the ray's
    death; with ``record_pay``, ``pay`` (D, 8, n_rays) float32 holds the
    bounce winner's fields cx cy cz rad cr cg cb in rows 0-6.  ``pay`` is
    defined only where ``rec >= 0`` (row 7 nowhere): the JAX kernel fills
    the other rows with ones for its masked divisions (pallas_kernel.py:
    998-1015); K2 reads pay only at bounces, so the kernel writes nothing
    there.  Without ``record_pay`` it is None.

    The kernel runs each ray on one thread or on one warp (32 lanes): both
    routes compute the same function bit for bit.  ``lanes_per_ray`` picks
    the route; ``_lanes`` (1 or 32, for tests and measurements only)
    overrides it.

    A CPU tensor takes the plain version; a CUDA tensor launches the CUDA
    kernel on the current stream, without synchronising, and under
    ``utils.trace.counting()`` counts the launch in ``k1.launches`` by its
    lanes per ray."""
    _check_launch(scene, params, n_rays, tile, block_tiled, state_in,
                  record_depth, record_pay, lane_groups)
    _check_lanes(_lanes)
    if params.device.type == "cpu":
        return megakernel_reference(
            scene, params, n_rays, tile, block_tiled=block_tiled,
            state_in=state_in, emit_state=emit_state, with_stats=with_stats,
            record_depth=record_depth, record_pay=record_pay, cull=cull,
            far_root=far_root, force_occl=force_occl,
            lane_groups=lane_groups)
    if params.device.type != "cuda":
        raise ValueError(f"unsupported device {params.device}")
    from . import _cuda
    fn = _cuda.load("megakernel")
    dev = params.device
    flags = _kernel_flags(scene, cull, force_occl)
    CB, CR = scene.aabbT.shape[:2]
    state_out = (torch.empty(N_STATE, n_rays, dtype=torch.float32, device=dev)
                 if emit_state else None)
    packed = (None if emit_state else
              torch.empty(n_rays, dtype=torch.int32, device=dev))
    stats = (torch.empty(N_STATS, n_rays, dtype=torch.int32, device=dev)
             if with_stats else None)
    rec = pay = None
    if record_depth is not None:
        rec = torch.empty(record_depth, n_rays, dtype=torch.int32, device=dev)
        if record_pay:
            pay = torch.empty(record_depth, 8, n_rays, dtype=torch.float32,
                              device=dev)
    lanes = _lanes or lanes_per_ray(n_rays, state_in is not None)
    # the warp-per-ray continuation's ray counter (the kernel zeroes it)
    work = (torch.empty(1, dtype=torch.int32, device=dev)
            if lanes > 1 and state_in is not None else None)

    rc = fn(_ptr(params), _ptr(scene.sphT), _ptr(scene.aabbT),
            _ptr(scene.superT), scene.n_clusters, CB, CR, flags.tail_rows,
            int(flags.cull), int(flags.occl), int(flags.two_level),
            scene.cluster_width, int(bool(far_root)), lanes,
            _ptr(state_in), _ptr(state_out), _ptr(packed), _ptr(stats),
            _ptr(rec), _ptr(pay), _ptr(work), record_depth or 0,
            n_rays, tile, int(block_tiled),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError("megakernel launch failed: "
                           + _cuda.error_string("megakernel", rc))
    c = counters()
    if c is not None:
        c.add("k1.launches", 1, f"lanes{lanes}")
    out = state_out if emit_state else packed
    if record_depth is not None:
        return out, stats, rec, pay
    return out, stats


def _ptr(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


# ---------------------------------------------------------------------------
# renders


class _RayOrder(NamedTuple):
    params: torch.Tensor
    n_rays: int
    block: tuple | None
    padded: tuple            # (hp, wp) for block tiles


def _ray_shape(width, height, tile, block) -> tuple:
    """The padded ray count and, for block tiles, the padded (hp, wp)."""
    if block is None:
        return -(-(width * height) // tile) * tile, (0, 0)
    bh, bw = block
    if bh * bw != tile:
        raise ValueError(f"block {block} does not cover tile {tile}")
    wp = -(-width // bw) * bw
    hp = -(-height // bh) * bh
    return wp * hp, (hp, wp)


@spanned("rt.rays")
def _ray_order(cam: Camera, width, height, tile, block, row0, total_height,
               depth) -> _RayOrder:
    """Params vector (pallas_kernel.py:1097-1135) and padded ray count:
    camera at 0-11, row offset 12, depth cap 13, w, h and their reciprocals
    16-19, block geometry 20-23."""
    th = height if total_height is None else total_height
    n_rays, (hp, wp) = _ray_shape(width, height, tile, block)
    if block is not None:
        bh, bw = block
        blk = [wp // bw, bw, bh, 1.0 / (wp // bw)]
    else:
        blk = [0.0] * 4
    rest = torch.tensor([float(row0), float(depth), 0.0, 0.0, width, th,
                         1.0 / width, 1.0 / th] + blk, dtype=torch.float32)
    dev = cam.origin.device
    if dev.type == "cuda":
        # a copy from pageable memory would wait for the device to drain
        # and stall the render's launches behind it
        rest = rest.pin_memory()
    params = torch.cat([cam.llc, cam.horizontal, cam.vertical, cam.origin,
                        rest.to(dev, non_blocking=True)])
    return _RayOrder(params, n_rays, block, (hp, wp))


def _to_image(ro: _RayOrder, flat, width, height):
    """Ray order -> image: (..., n_rays) -> (..., h, w)
    (pallas_kernel.py:1121-1147)."""
    lead = flat.shape[:-1]
    if ro.block is None:
        return flat[..., :width * height].reshape(*lead, height, width)
    (bh, bw), (hp, wp) = ro.block, ro.padded
    k = len(lead)
    return (flat.reshape(*lead, hp // bh, wp // bw, bh, bw)
            .permute(*range(k), k, k + 2, k + 1, k + 3)
            .reshape(*lead, hp, wp)[..., :height, :width])


def _count_sum(x: torch.Tensor) -> int:
    """Exact sum of per-ray int32 counters (int64 accumulation)."""
    return int(x.sum(dtype=torch.int64).item())


def _stats_dict(stats: torch.Tensor) -> dict:
    return {name: _count_sum(s) for name, s in zip(STAT_NAMES, stats)}


def _count_phase(c, k: int, n_rays: int, live_in, stats):
    """Phase k's launch into the counters ``c``: the rays it runs, those
    live at its entry, and K1's per-ray counters summed, on the device,
    where ``c`` ran K1's counting variant."""
    part = f"phase{k}"
    c.add("k1.rays_launched", n_rays, part)
    c.add("k1.rays_live_in", live_in, part)
    if not stats_on(c):
        return
    for name, s in zip(STAT_NAMES, stats.sum(dim=1, dtype=torch.int64)):
        c.add(f"k1.{name}", s, part)


def render_pallas(scene: PallasScene, cam: Camera, width: int, height: int,
                  max_depth: int = MAX_DEPTH, tile: int = DEFAULT_TILE,
                  far_root: bool = True, block: tuple | None = None,
                  cull: bool | None = None, row0=0.0,
                  total_height: int | None = None,
                  lane_groups: int | None = None, with_stats: bool = False,
                  kernel: Callable = megakernel):
    """Render -> packed int32 (h, w) with one K1 launch
    (pallas_kernel.py:1071-1147).  ``block=(bh, bw)`` with bh*bw == tile
    maps tiles to image rectangles instead of scanline runs; ``cull``
    (default: C > 1) turns AABB culling on or off, with the same image;
    ``row0`` / ``total_height`` render rows [row0, row0+height) of a
    taller image; ``far_root`` and ``lane_groups`` as in ``megakernel``.
    ``kernel`` is what runs K1: the wrapper, or anything with its signature
    (its plain version, or a checking or timing wrapper)."""
    ro = _ray_order(cam, width, height, tile, block, row0, total_height,
                    max_depth)
    c = counters()
    with span("rt.phase0"):
        out, stats = kernel(scene, ro.params, ro.n_rays, tile,
                            block_tiled=block is not None,
                            with_stats=with_stats or stats_on(c),
                            cull=cull, far_root=far_root,
                            lane_groups=lane_groups)
    if c is not None:
        _count_phase(c, 0, ro.n_rays, ro.n_rays, stats)
    img = _to_image(ro, out, width, height)
    return (img, _stats_dict(stats)) if with_stats else img


def _sort_prefixes(sort_prefix, n_phases, n_rays, tile):
    """Static row count of each boundary sort (None: the whole array)."""
    if sort_prefix is None:
        return [None] * n_phases
    prefs = [None if f is None or f >= 1.0
             else max(tile, int(n_rays * f) // tile * tile)
             for f in sort_prefix]
    return prefs + [None] * (n_phases - len(prefs))


def _bsort_perm(key: torch.Tensor, prefix: int | None,
                segments: int = 1) -> torch.Tensor:
    """Permutation of the boundary sort (pallas_kernel.py:1644-1662): sort
    the unique keys of ``key[:prefix]`` and leave the suffix in place; with
    no prefix, sort the whole array or, with ``segments`` S > 1, each of its
    S rows of L = n / S rays on its own."""
    n = key.shape[0]
    if prefix is not None and 0 < prefix < n:
        head = torch.sort(key[:prefix]).indices
        return torch.cat([head, torch.arange(prefix, n, device=key.device)])
    if segments == 1:
        return torch.sort(key).indices
    L = n // segments
    rows = torch.sort(key.view(segments, L), dim=1).indices
    return (rows + torch.arange(0, n, L, device=key.device)[:, None]).view(n)


def _coherent_key(st: torch.Tensor, dead: torch.Tensor, scene: PallasScene):
    """The ``coherent`` boundary key (pallas_kernel.py:1664-1672,
    1720-1727): ``(dead << 30) | (octant << 27) | (morton3d(pos) >> 3)``,
    the position normalised to the scene's bounds (padding clusters are
    +inf/-inf boxes, neutral under min/max).  Not unique: the caller sorts
    it stably and carries the ray id as a payload."""
    box = scene.aabbT.reshape(-1, 8)
    lo, hi = box[:, 0:3].amin(dim=0), box[:, 3:6].amax(dim=0)
    span = hi - lo
    inv = torch.where(span > 0, 1.0 / torch.where(span > 0, span, 1.0), 0.0)
    octant = ((st[3] < 0).to(torch.int32)
              | ((st[4] < 0).to(torch.int32) << 1)
              | ((st[5] < 0).to(torch.int32) << 2))
    m = morton3d((st[0:3].T - lo) * inv)                    # < 2^30, int64
    return (dead << 30) | (octant << 27) | (m >> 3).to(torch.int32)


class _Frame:
    """One multi-phase frame's launches after its params vector, span by
    span, and the tensors that cross from a span to a later one: the last
    phase's state ``st``, the next phase's input ``state_in``, the dead
    rays' pixels ``acc_pix``, each ray's original id ``idx``, each
    boundary's live mask (``lives``) and the image ``img``.  ``spans()``
    gives each span's name and launches in order; ``run()`` runs them, each
    inside its span.  A span reads only what the spans before it wrote in
    the same run, so a second run renders the frame again.  ``stats`` holds
    each phase's per-ray counters (None where K1 ran without them)."""

    def __init__(self, scene, ro, width, height, depths, tile, tile2,
                 segments, prefs, block, coherent, occl_cont, kernel, kw):
        self.scene, self.ro, self.width, self.height = scene, ro, width, height
        self.depths, self.tile, self.tile2 = depths, tile, tile2
        self.segments = self.unpermute_segments = segments
        self.prefs, self.block = prefs, block
        self.coherent, self.occl_cont = coherent, occl_cont
        self.kernel, self.kw = kernel, kw
        self.st = self.state_in = self.acc_pix = self.idx = self.img = None
        self.stats = [None] * len(depths)
        self.lives = [None] * (len(depths) - 1)

    def spans(self) -> list:
        last = len(self.depths) - 1
        out = []
        for k in range(last + 1):
            out.append((f"rt.phase{k}", functools.partial(self._phase, k)))
            if k < last:
                out.append((f"rt.boundary{k}",
                            functools.partial(self._boundary, k)))
        return out + [("rt.unpermute", self._unpermute)]

    def run(self) -> None:
        for name, launches in self.spans():
            with span(name):
                launches()

    def count(self, c) -> None:
        """The frame's rays and K1's counters, by phase, into ``c``."""
        n = self.ro.n_rays
        for k, stats in enumerate(self.stats):
            live_in = n if k == 0 else torch.count_nonzero(self.lives[k - 1])
            _count_phase(c, k, n, live_in, stats)

    def _phase(self, k: int) -> None:
        params = self.ro.params.clone()
        params[13:14].fill_(self.depths[k])  # on the device, no host copy
        self.st, stats = self.kernel(
            self.scene, params, self.ro.n_rays,
            self.tile if k == 0 else self.tile2,
            block_tiled=(k == 0 and self.block is not None),
            state_in=self.state_in if k > 0 else None, emit_state=True,
            force_occl=self.occl_cont and k > 0, **self.kw)
        self.stats[k] = stats

    def _boundary(self, k: int) -> None:
        # rays that died this phase hold their colour in rr/rg/rb (zero for
        # the others), so a plain add takes each pixel from one phase
        st, n = self.st, self.ro.n_rays
        pix = pack_pix(st[9], st[10], st[11])
        acc_pix = pix if k == 0 else self.acc_pix + pix
        idx = (torch.arange(n, dtype=torch.int32, device=st.device)
               if k == 0 else self.idx)
        dead = (st[12] <= 0.0).to(torch.int32)
        if self.coherent:
            key = _coherent_key(st, dead, self.scene)
            perm = torch.sort(key, stable=True).indices
            idx = idx[perm]
            key_sorted = key[perm]
        else:
            key = (dead << 30) | idx
            prefix = self.prefs[k]
            perm = _bsort_perm(key, prefix, self.segments)
            key_sorted = key[perm]
            idx = key_sorted & ((1 << 30) - 1)
            if prefix is not None and 0 < prefix < n:
                self.unpermute_segments = 1     # rays left their segments
        self.acc_pix, self.idx = acc_pix[perm], idx
        live = ((key_sorted >> 30) == 0).to(torch.float32)
        self.lives[k] = live
        self.state_in = torch.cat([st[:9, perm], st.new_zeros(3, n),
                                   live[None]])

    def _unpermute(self) -> None:
        # merge the last phase's pixels with the earlier ones, then put them
        # back in ray order by sorting on the original ray id
        st = self.st
        pix = pack_pix(st[9], st[10], st[11])
        merged = torch.where(self.state_in[12] > 0.0, pix, self.acc_pix)
        unperm = _bsort_perm(self.idx, None, self.unpermute_segments)
        self.img = _to_image(self.ro, merged[unperm], self.width,
                             self.height)


GRAPH_ENTRIES = 4       # keys kept, the least recently used dropped first
_graphs: OrderedDict = OrderedDict()    # key -> _FrameGraphs, or _Seen


def megakernel_eager(*args, **kw):
    """``megakernel`` under another name: a multi-phase frame through it
    runs its launches one by one, since the graphs engage for ``megakernel``
    alone; what a replayed frame is checked and timed against."""
    return megakernel(*args, **kw)


def release_graphs() -> None:
    """Drop every kept frame graph, and with it its memory pool and its
    hold on its layout."""
    _graphs.clear()


def _graphs_engage(device, kernel, with_stats: bool, c) -> bool:
    """Whether a multi-phase frame may run from CUDA graphs: on a CUDA
    device, through K1's own wrapper (a checking or timing ``kernel`` keeps
    every launch it wraps), and without K1's counters, asked for or run
    under ``counting()`` with stats (K1's counting variant)."""
    return (device.type == "cuda" and kernel is megakernel
            and not with_stats and not stats_on(c))


def _graph_key(scene: PallasScene, device, *static) -> tuple:
    """What a frame's captured launches depend on besides the camera: the
    address, shape and dtype of each layout tensor, the device, and the
    render's static arguments, in a fixed order (a list as a tuple).  Its
    cost is host time at the start of every frame, before the first
    launch."""
    return (device, tuple((t.data_ptr(), t.shape, t.dtype) for t in scene),
            tuple(tuple(v) if isinstance(v, list) else v for v in static))


def _capture(launches: Callable, pool):
    """``launches()`` captured as a CUDA graph in the memory pool
    ``pool``."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool):
        launches()
    return graph


def _keep_graphs(key, graphs) -> None:
    _graphs[key] = graphs
    while len(_graphs) > GRAPH_ENTRIES:
        _graphs.popitem(last=False)


class _Seen:
    """A key's first frame, by weak references to its layout tensors: it
    keeps none of them alive, and ``of(scene)`` holds only while those
    very tensors live, so a layout built later at a freed layout's
    addresses is new to it."""

    def __init__(self, scene: PallasScene):
        self.refs = [weakref.ref(t) for t in scene]

    def of(self, scene: PallasScene) -> bool:
        return all(r() is t for r, t in zip(self.refs, scene))


class _FrameGraphs:
    """A frame's spans captured as CUDA graphs, one a span, all in one
    memory pool, and replayed in the order captured.  It holds the layout
    (the graphs read its tensors at their addresses, which no other tensor
    can take while it lives) and the captured ``_Frame``: the params vector,
    the graphs' one input, and the tensors that cross spans, among them
    the image and the live masks, which are read after a replay.  The
    capture counts K1's launches as the eager chain would, once, into
    ``launches`` and the ``counting()`` around it; the frames that replay
    it later add ``launches`` again."""

    def __init__(self, scene: PallasScene, frame: _Frame):
        self.scene, self.frame = scene, frame
        pool = torch.cuda.graph_pool_handle()
        self.graphs = []
        with counting(stats=False) as self.launches:
            for name, launches in frame.spans():
                with span(name):
                    self.graphs.append((name, _capture(launches, pool)))

    def replay(self, cam: Camera) -> torch.Tensor:
        """The frame of ``cam``: its 12 floats copied into the params
        vector, each span's graph replayed, the image copied out of the
        pool into a tensor of its own, which the next replay leaves as it
        is; the rays and survivors a phase counted."""
        with span("rt.rays"):
            torch.cat([cam.llc, cam.horizontal, cam.vertical, cam.origin],
                      out=self.frame.ro.params[:12])
        for name, graph in self.graphs[:-1]:
            with span(name):
                graph.replay()
        name, graph = self.graphs[-1]
        with span(name):
            graph.replay()
            img = self.frame.img.clone()
        c = counters()
        if c is not None:
            self.frame.count(c)
        return img


def render_pallas_twophase(scene: PallasScene, cam: Camera, width: int,
                           height: int, max_depth: int = MAX_DEPTH,
                           phase1_depth: int = 6, tile: int = DEFAULT_TILE,
                           far_root: bool = True, cull: bool | None = None,
                           block: tuple | None = None, row0=0.0,
                           total_height: int | None = None,
                           tile2: int | None = None,
                           lane_groups: int | None = None,
                           schedule: tuple | None = None,
                           coherent: bool = False, occl_cont: bool = False,
                           seg_tiles: int | None = None,
                           sort_prefix: tuple | None = None,
                           with_stats: bool = False,
                           kernel: Callable = megakernel):
    """Multi-phase render with survivor compaction between phases
    (pallas_kernel.py:1496-1792).

    Phase k traces every ray to the depth cap ``schedule[k]`` (default
    ``(phase1_depth,)``) and emits its state; the last phase runs to
    ``max_depth``.  At each boundary one sort on the unique key
    ``(dead << 30) | ray_id`` packs the survivors into a prefix (boundary k
    sorts only the first ``sort_prefix[k]`` fraction of the rays, rounded
    to ``tile2``; exact for any survival rate).  Each ray's pixel comes from
    the phase it dies in, accumulated in ``acc_pix``, merged with the last
    phase's pixels and put back in ray order by sorting on the ray id.  The
    image is bit-identical to ``render_pallas``.

    ``tile2`` (default ``tile``) is the continuation phases' tile: their
    ray-order parameter, which must divide the padded ray count.
    ``seg_tiles`` compacts within S = (rays / tile2) / seg_tiles segments
    (when that divides evenly and S > 1): a boundary without a prefix sorts
    each segment on its own, and so does the final unpermute while no
    prefix sort has moved rays across segments.  (JAX's unpermute stays
    segmented after a prefix sort too, which scrambles its image; this
    port's then sorts the whole array: ROADMAP queue 3.)  ``coherent``
    packs survivors by direction octant and position Morton code instead
    of ray id (one global stable sort, the ray id a payload; forces S = 1,
    no prefixes): the same image.  ``occl_cont`` forces the occlusion gate
    on in every continuation phase, even at C <= 16, which may move a
    winner within one 2^-16 key-floor bucket.  ``far_root``, ``cull`` and
    ``lane_groups`` pass to every launch, as in ``render_pallas``.

    ``with_stats`` also returns exact counter sums, in total and per phase.
    ``kernel`` runs K1, as in ``render_pallas``.

    Where ``_graphs_engage`` holds (a CUDA device, K1's own wrapper, no K1
    counters), a frame whose ``_graph_key`` (the layout tensors' addresses,
    shapes and dtypes, the device, the static arguments: all but the
    camera) was seen once before captures each span's launches as a CUDA
    graph, and later frames with that key replay them; the first frame runs
    its launches one by one, as every other frame does.  A key counts as
    seen only while its first frame's layout tensors live, so a layout
    rebuilt every frame never captures.  The image is the same bit for bit,
    in a tensor of its own.  ``render.graph`` counts each frame's route.
    The graphs of up to ``GRAPH_ENTRIES`` keys are kept, each with its
    layout and its memory pool (317 MB reserved at 1000x1000), until they
    are the least recently used of more keys or ``release_graphs()`` drops
    them: until then the layout outlives the caller's references.
    """
    if schedule is None:
        schedule = (phase1_depth,)
    if sum(schedule) >= max_depth:
        raise ValueError(f"schedule {schedule} must end before max_depth "
                         f"{max_depth}")
    Rp = _ray_shape(width, height, tile, block)[0]
    t2 = tile if tile2 is None else tile2
    if t2 <= 0 or Rp % t2:
        raise ValueError(f"tile2 {t2} must divide the {Rp} padded rays")
    nt2 = Rp // t2
    S = (nt2 // seg_tiles if seg_tiles and not coherent
         and nt2 % seg_tiles == 0 and nt2 > seg_tiles else 1)
    prefs = _sort_prefixes(sort_prefix, len(schedule), Rp, t2)
    depths = list(schedule) + [max_depth - sum(schedule)]
    c = counters()
    kw = dict(far_root=far_root, cull=cull, lane_groups=lane_groups,
              with_stats=with_stats or stats_on(c))

    def frame() -> _Frame:
        ro = _ray_order(cam, width, height, tile, block, row0, total_height,
                        0)
        return _Frame(scene, ro, width, height, depths, tile, t2, S, prefs,
                      block, coherent, occl_cont, kernel, kw)

    dev = cam.origin.device
    if _graphs_engage(dev, kernel, with_stats, c):
        key = _graph_key(scene, dev, width, height, max_depth, schedule,
                         sort_prefix, tile, tile2, block, row0, total_height,
                         seg_tiles, coherent, occl_cont, far_root, cull,
                         lane_groups)
        graphs = _graphs.pop(key, None)
        if isinstance(graphs, _FrameGraphs):
            route = "replay"
            if c is not None:
                c.add_all(graphs.launches)
        elif isinstance(graphs, _Seen) and graphs.of(scene):
            # the key's first frame ran its launches one by one: kernels
            # loaded, K1's occupancy kept, the sorts' workspace sized
            graphs, route = _FrameGraphs(scene, frame()), "capture"
        else:
            graphs, route = _Seen(scene), "eager"
        _keep_graphs(key, graphs)
        if route != "eager":
            count("render.graph", 1, route)
            return graphs.replay(cam)
    count("render.graph", 1, "eager")
    fr = frame()
    fr.run()
    if c is not None:
        fr.count(c)
    if not with_stats:
        return fr.img
    per = [_stats_dict(s) for s in fr.stats]
    out = {f"phase_{k}": [p[k] for p in per]
           for k in ("slot_tests", "ray_bounces", "cull_rows")}
    out.update({k: sum(p[k] for p in per)
                for k in ("slot_tests", "ray_bounces", "cull_rows")})
    return fr.img, out


# ---------------------------------------------------------------------------
# record renders (K1d)


def render_pallas_record(scene: PallasScene, cam: Camera, width: int,
                         height: int, max_depth: int = MAX_DEPTH,
                         tile: int = DEFAULT_TILE, far_root: bool = True,
                         cull: bool | None = None, with_pay: bool = False,
                         block: tuple | None = None,
                         kernel: Callable = megakernel):
    """Float colours and the per-bounce path record from one K1d launch
    (pallas_kernel.py:1150-1224).

    Returns (colours (h, w, 3) float32, record (max_depth, h*w) int32): per
    step and pixel (row-major), the winner slot ``cluster*128 + lane`` of a
    mirror bounce, -1 a miss, -2 inactive, -3 absorbed.  ``with_pay`` adds
    the raw records in ray order, ``rec`` (D, n_rays) and ``pay``
    (D, 8, n_rays), as ``megakernel`` returns them, for the backward
    replay.  ``far_root``, ``cull``, ``block`` and ``kernel`` as in
    ``render_pallas``."""
    ro = _ray_order(cam, width, height, tile, block, 0.0, None, max_depth)
    c = counters()
    stat_kw = dict(with_stats=True) if stats_on(c) else {}
    with span("rt.phase0"):
        st, stats, rec, pay = kernel(
            scene, ro.params, ro.n_rays, tile, block_tiled=block is not None,
            emit_state=True, record_depth=max_depth, record_pay=with_pay,
            cull=cull, far_root=far_root, **stat_kw)
    if c is not None:
        _count_phase(c, 0, ro.n_rays, ro.n_rays, stats)
    colours = _to_image(ro, st[9:12], width, height).permute(1, 2, 0)
    record = _to_image(ro, rec, width, height).reshape(max_depth, -1)
    if with_pay:
        return colours.contiguous(), record, rec, pay
    return colours.contiguous(), record


def render_pallas_record_twophase(scene: PallasScene, cam: Camera,
                                  width: int, height: int,
                                  max_depth: int = MAX_DEPTH,
                                  phase1_depth: int = 6,
                                  tile: int = DEFAULT_TILE,
                                  far_root: bool = True,
                                  cull: bool | None = None,
                                  block: tuple | None = None,
                                  schedule: tuple | None = None,
                                  sort_prefix: tuple | None = None,
                                  kernel: Callable = megakernel):
    """Record-mode render with survivor compaction between phases
    (pallas_kernel.py:1227-1380): ``render_pallas_twophase``'s schedule and
    prefix sorts, accumulating float colours, with the records each
    segment of the backward replay needs.

    ``schedule`` gives the depth caps of all phases but the last (default
    ``(phase1_depth,)``); segment k records ``depths[k]`` steps.  Returns
    (colours (h, w, 3) float32, aux) with

      recs[k] (D_k, n_rays) int32, pays[k] (D_k, 8, n_rays) float32
          segment k's records, in segment k's ray order (segment 0 in the
          scanline or block order, later ones compacted);
      states[k] (9, n_rays) float32
          o, d and light after boundary k, sorted into segment k+1's order
          (rows 0-8 of the JAX package's ``states16``);
      poskeys[k] (n_rays,) int32
          ``(dead << 30) | position`` sorted by boundary k: the low bits are
          each ray's position in segment k's order, so they invert the
          boundary's permutation (the backward's carry hand-off);
      schedule, sort_prefix_rows
          the schedule and each boundary's sorted row count (None: all).

    Boundary k sorts the key ``(dead << 30) | position`` of the first
    ``sort_prefix[k]`` share of the rays (rounded to tiles) and leaves the
    rest in place, which is exact for any survival rate.  Per-ray arithmetic
    is the single-phase record's, so the colours are bit-identical to
    ``render_pallas_record``'s.  ``far_root`` and ``cull`` pass to every
    launch."""
    if schedule is None:
        schedule = (phase1_depth,)
    if sum(schedule) >= max_depth:
        raise ValueError(f"schedule {schedule} must end before max_depth "
                         f"{max_depth}")
    ro = _ray_order(cam, width, height, tile, block, 0.0, None, 0)
    Rp = ro.n_rays
    dev = ro.params.device
    prefs = _sort_prefixes(sort_prefix, len(schedule), Rp, tile)
    depths = list(schedule) + [max_depth - sum(schedule)]
    pos = torch.arange(Rp, dtype=torch.int32, device=dev)

    c = counters()
    stat_kw = dict(with_stats=True) if stats_on(c) else {}

    recs, pays, states, poskeys = [], [], [], []
    idx = pos                 # each ray's original id, in the current order
    acc = state_in = None     # dead rays' colours (3, Rp); next phase's input
    live_in = Rp
    for k, depth in enumerate(depths):
        with span(f"rt.phase{k}"):
            st, stats, rec, pay = kernel(
                scene, ro.params, Rp, tile,
                block_tiled=(k == 0 and block is not None),
                state_in=state_in, emit_state=True, record_depth=depth,
                record_pay=True, cull=cull, far_root=far_root, **stat_kw)
        if c is not None:
            _count_phase(c, k, Rp, live_in, stats)
        recs.append(rec)
        pays.append(pay)
        if k == len(schedule):
            break
        with span(f"rt.boundary{k}"):
            # a ray dies in one phase; continuations start from zeroed
            # rr/rg/rb, so the sum takes each ray's colour from its phase
            acc = st[9:12] if acc is None else acc + st[9:12]
            key = ((st[12] <= 0.0).to(torch.int32) << 30) | pos
            perm = _bsort_perm(key, prefs[k])
            key_sorted = key[perm]
            poskeys.append(key_sorted)
            acc = acc[:, perm]
            idx = idx[perm]
            states.append(st[:9, perm])
            live = ((key_sorted >> 30) == 0).to(torch.float32)
            state_in = torch.cat([states[-1], st.new_zeros(3, Rp),
                                  live[None]])
        if c is not None:
            live_in = torch.count_nonzero(live)
    # the last phase's colours where its rays were live at entry, then back
    # to ray order by sorting on the original ray id
    with span("rt.unpermute"):
        merged = torch.where(state_in[12] > 0.0, st[9:12], acc)
        col = merged[:, torch.sort(idx).indices]
        colours = (_to_image(ro, col, width, height).permute(1, 2, 0)
                   .contiguous())
    return colours, dict(recs=recs, pays=pays, states=states,
                         poskeys=poskeys, schedule=tuple(schedule),
                         sort_prefix_rows=prefs)
