"""The forward megakernel K1: scene layout, wrapper, plain version, renders.

Counterpart of ``raytracers_tpu.render.pallas_kernel`` (the TPU kernel
``_megakernel`` and its host-side glue) for the forward render path:

* ``PallasScene`` / ``build_pallas_scene`` lay the scene out exactly as the
  JAX package does (same tables, bit for bit), so the two packages render
  from the same data and the layout tests can hold them equal;
* ``megakernel`` is the wrapper of the hand-written CUDA kernel
  (``csrc/megakernel.cu``), one thread per ray; on a CPU tensor it takes
  ``megakernel_reference``, the plain torch version with the same per-ray
  arithmetic;
* ``render_pallas`` (one launch) and ``render_pallas_twophase`` (phases with
  survivor-compaction sorts between them, then an unpermute sort) drive it;
* ``render_pallas_record`` and ``render_pallas_record_twophase`` drive its
  record mode (K1d): float colours plus, per step, each ray's winner slot
  and the winner's fields, which the backward replay (K2,
  ``grad/replay_bwd.py``) differentiates.

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
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..bvh.lbvh import Clusters, build_clusters
from ..geometry import MAX_DEPTH, SCENE_EPSILON, T_MAX, Camera, Spheres
from ..vec import sqrt
from .ray_math import bounce, quad, search_m, sky

LANE = 128            # spheres per cluster
DEFAULT_TILE = 512    # rays per tile of the ray order
_BIG = float(T_MAX)

_KEY_MASK = -LANE                                       # clears 7 low bits
_HIT_TH = int(np.float32(_BIG).view(np.int32)) & _KEY_MASK
_KRUN_INIT = _HIT_TH | (LANE - 1)

N_STATE = 13   # ox oy oz dx dy dz lr lg lb rr rg rb active
N_STATS = 3    # sphere rows tested, bounces run, AABB slab rows tested


class PallasScene(NamedTuple):
    """Scene laid out for the megakernel (pallas_kernel.py:80-114).

    C clusters of 128 Morton-sorted spheres; CB = ceil(C / CR) blocks of
    CR cull rows.  ``sphT`` (C,128,8) and ``sph8`` (C,8,128) hold the fields
    cx cy cz rad cr cg cb r^2; ``aabbT`` (CB,CR,8) the cluster AABBs
    (padding clusters +inf/-inf); ``superT`` (1,SBR,8) the per-block
    unions; ``order`` (C,128) int32 the original sphere index of each slot
    (-1 padding); ``tailT``/``tail8`` the last cluster's first P rows, the
    peel of a partial final cluster (P == 128: no peel).
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


def build_pallas_scene(sph: Spheres, sort_origin=None) -> PallasScene:
    """Morton-sort and cluster the scene into the kernel layout
    (pallas_kernel.py:121-300, at cluster width 128).

    ``sort_origin`` (normally the camera origin) orders the clusters
    front-to-back by the distance of their AABB centres, within each block
    of CR clusters (and, for scene-scale layouts, the full blocks too), so
    the occlusion gate of C > 16 scenes prunes far clusters.  The argsorts
    are stable: irreg's grid is symmetric about its camera and many
    distances tie.  Scene-scale layouts (C > 128) take blocks of CR = 64
    cull rows, as the JAX package does by default."""
    W = LANE
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

    CR = max(8, -(-C // 8) * 8) if C <= LANE else 64

    leaf_min, leaf_max = clusters.leaf_min, clusters.leaf_max
    order2d = clusters.order.reshape(C, W)
    perm = None
    if sort_origin is not None and C > 16:
        o = torch.tensor(sort_origin, dtype=torch.float32, device=dev)
        d = 0.5 * (leaf_min + leaf_max) - o
        dist = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
        segs = [b0 + torch.argsort(dist[b0:min(b0 + CR, C)], stable=True)
                for b0 in range(0, C, CR)]
        n_full = C // CR
        if n_full >= 2:
            # scene scale: full blocks front-to-back too; the partial tail
            # block stays last
            blk_d = torch.stack([dist[b0:b0 + CR].amin()
                                 for b0 in range(0, n_full * CR, CR)])
            border = torch.argsort(blk_d, stable=True)
            full = torch.stack(segs[:n_full])
            segs = [full[border].reshape(-1)] + segs[n_full:]
        perm = torch.cat(segs)
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
    ], dim=1)                                             # (C, 8, 128)
    sphT = sph8.transpose(1, 2).contiguous()              # (C, 128, 8)

    CB = -(-C // CR)
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

    SBR = max(8, -(-CB // 8) * 8)
    blk_min = aabbT[:, :, 0:3].amin(dim=1)                # (CB, 3)
    blk_max = aabbT[:, :, 3:6].amax(dim=1)
    superT = torch.cat([
        torch.cat([blk_min, blk_min.new_full((SBR - CB, 3), inf)]),
        torch.cat([blk_max, blk_max.new_full((SBR - CB, 3), -inf)]),
        blk_min.new_zeros(SBR, 2),
    ], dim=1)[None]                                       # (1, SBR, 8)

    # tail peel only while the partial cluster is still last
    n_tail = n - (C - 1) * W
    P = W
    if perm is None and n_tail < W:
        P = 8
        while P < n_tail:
            P *= 2
    return PallasScene(sphT=sphT, sph8=sph8.contiguous(), aabbT=aabbT,
                       superT=superT, order=order2d,
                       tailT=sphT[C - 1, :P, :].contiguous(),
                       tail8=sph8[C - 1, :, :P].contiguous())


def _check_supported(scene: PallasScene) -> None:
    if scene.aabbT.shape[0] > 1:
        raise NotImplementedError(
            "scene-scale layouts (more than one cluster block, C > 128) need "
            "the two-level cull, which is not ported yet (ROADMAP queue 2, "
            "K1e)")
    if scene.sphT.shape[1] != LANE:
        raise NotImplementedError("only 128-sphere clusters are ported")


def _kernel_flags(scene: PallasScene):
    """(cull, occlusion gate, rows of the last cluster) as the TPU kernel
    derives them: culling for C > 1, the occlusion gate for C > 16, and
    the tail peel when P < 128 (pallas_kernel.py:725,789,1094)."""
    C = scene.n_clusters
    cull = C > 1
    return cull, cull and C > 16, scene.tailT.shape[0]


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


def _closest_hit_reference(scene: PallasScene, cull: bool, occl: bool,
                           tail_rows: int, ox, oy, oz, dx, dy, dz, a):
    """Per-ray culled packed-key search over the live rays.  Returns the
    winning key, the winner's cluster and the sphere rows each ray tested."""
    sphT = scene.sphT
    C = scene.n_clusters
    m = ox.shape[0]
    epsa = SCENE_EPSILON * a
    krun = torch.full((m,), _KRUN_INIT, dtype=torch.int32, device=ox.device)
    wcl = torch.zeros(m, dtype=torch.int64, device=ox.device)
    slots = torch.zeros(m, dtype=torch.int32, device=ox.device)
    lanes = torch.arange(LANE, dtype=torch.int32, device=ox.device)
    if cull:
        # slab of every cluster AABB at once: (m, C), min/max propagate NaN
        box = scene.aabbT.reshape(-1, 8)[:C]
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
        slab_ok = ~(torch.minimum(hi, big) <= torch.maximum(lo, zero))
    for c in range(C):
        rows = tail_rows if c == C - 1 else LANE
        if cull:
            keep = slab_ok[:, c]
            if occl:
                best_f = (krun & _KEY_MASK).view(torch.float32)
                keep = keep & ~(lo[:, c] * a >= best_f)
            idx = keep.nonzero().squeeze(1)
            if idx.numel() == 0:
                continue
        else:
            idx = torch.arange(m, device=ox.device)
        s = sphT[c, :rows]                                   # (rows, 8)
        q = quad(ox[idx, None], oy[idx, None], oz[idx, None],
                 dx[idx, None], dy[idx, None], dz[idx, None], a[idx, None],
                 s[:, 0], s[:, 1], s[:, 2], s[:, 7])
        tv = search_m(q, sqrt(q.disc), epsa[idx, None])
        key = (tv.view(torch.int32) & _KEY_MASK) | lanes[:rows]
        kmin = key.amin(dim=1)
        cur = krun[idx]
        imp = kmin < cur
        krun[idx] = torch.where(imp, kmin, cur)
        wcl[idx] = torch.where(imp, c, wcl[idx])
        slots[idx] += rows
    return krun, wcl, slots


def megakernel_reference(scene: PallasScene, params: torch.Tensor,
                         n_rays: int, tile: int, *, block_tiled: bool = False,
                         state_in: torch.Tensor | None = None,
                         emit_state: bool = False, with_stats: bool = False,
                         record_depth: int | None = None,
                         record_pay: bool = False):
    """Plain torch version of K1, on any device, with the kernel's per-ray
    arithmetic: square roots correctly rounded through float64, no fused
    multiply-adds.  Bounces run over the live rays only and each cluster
    over the rays its gates pass.  Same arguments and results as
    ``megakernel``."""
    _check_supported(scene)
    cull, occl, tail_rows = _kernel_flags(scene)
    dev = params.device
    S = (_gen_rays(params, n_rays, tile, block_tiled) if state_in is None
         else state_in.clone())
    stats = torch.zeros(N_STATS, n_rays, dtype=torch.int32, device=dev)
    C = scene.n_clusters
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
        krun, wcl, slots = _closest_hit_reference(
            scene, cull, occl, tail_rows, ox, oy, oz, dx, dy, dz, a)
        stats[0, live] += slots
        stats[1, live] += 1
        stats[2, live] += C if cull else 0

        hit = krun < _HIT_TH
        lane = krun & (LANE - 1)
        w = scene.sphT[wcl, lane.long()]                       # (m, 8)
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
                  state_in, record_depth=None, record_pay=False):
    dev = params.device
    if record_pay and record_depth is None:
        raise ValueError("record_pay needs record_depth")
    if record_depth is not None and record_depth < 1:
        raise ValueError(f"record_depth {record_depth} must be >= 1")
    _check_supported(scene)
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
                    ("state_in", state_in)):
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
               record_depth: int | None = None, record_pay: bool = False):
    """K1: trace ``n_rays`` rays until they die or reach the depth cap
    ``params[13]``.

    Rays are generated from the camera in ``params`` (mode K1a; scanline or
    ``block_tiled``) or continue from ``state_in`` (13, n_rays) (K1b).  The
    result is the packed int32 (n_rays,) image in ray order, or with
    ``emit_state`` the (13, n_rays) state; ``with_stats`` adds (3, n_rays)
    int32 per-ray counters (K1c): sphere rows tested, bounces run, AABB
    slab rows tested.  Returns (out, stats or None).

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

    A CPU tensor takes the plain version; a CUDA tensor launches the CUDA
    kernel on the current stream, without synchronising, and counts the
    launch in ``megakernel.launches``."""
    _check_launch(scene, params, n_rays, tile, block_tiled, state_in,
                  record_depth, record_pay)
    if params.device.type == "cpu":
        return megakernel_reference(
            scene, params, n_rays, tile, block_tiled=block_tiled,
            state_in=state_in, emit_state=emit_state, with_stats=with_stats,
            record_depth=record_depth, record_pay=record_pay)
    if params.device.type != "cuda":
        raise ValueError(f"unsupported device {params.device}")
    from . import _cuda
    fn = _cuda.load("megakernel")
    dev = params.device
    cull, occl, tail_rows = _kernel_flags(scene)
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

    rc = fn(_ptr(params), _ptr(scene.sphT), _ptr(scene.aabbT),
            scene.n_clusters, tail_rows, int(cull), int(occl),
            _ptr(state_in), _ptr(state_out), _ptr(packed), _ptr(stats),
            _ptr(rec), _ptr(pay), record_depth or 0,
            n_rays, tile, int(block_tiled),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError("megakernel launch failed: "
                           + _cuda.error_string("megakernel", rc))
    megakernel.launches += 1
    out = state_out if emit_state else packed
    if record_depth is not None:
        return out, stats, rec, pay
    return out, stats


def _ptr(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


megakernel.launches = 0


# ---------------------------------------------------------------------------
# renders


class _RayOrder(NamedTuple):
    params: torch.Tensor
    n_rays: int
    block: tuple | None
    padded: tuple            # (hp, wp) for block tiles


def _ray_order(cam: Camera, width, height, tile, block, row0, total_height,
               depth) -> _RayOrder:
    """Params vector (pallas_kernel.py:1097-1135) and padded ray count:
    camera at 0-11, row offset 12, depth cap 13, w, h and their reciprocals
    16-19, block geometry 20-23."""
    th = height if total_height is None else total_height
    if block is not None:
        bh, bw = block
        if bh * bw != tile:
            raise ValueError(f"block {block} does not cover tile {tile}")
        wp = -(-width // bw) * bw
        hp = -(-height // bh) * bh
        n_rays = wp * hp
        blk = [wp // bw, bw, bh, 1.0 / (wp // bw)]
    else:
        n_rays = -(-(width * height) // tile) * tile
        wp = hp = 0
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
    return dict(slot_tests=_count_sum(stats[0]),
                ray_bounces=_count_sum(stats[1]),
                cull_rows=_count_sum(stats[2]))


def render_pallas(scene: PallasScene, cam: Camera, width: int, height: int,
                  max_depth: int = MAX_DEPTH, tile: int = DEFAULT_TILE,
                  block: tuple | None = None, row0=0.0,
                  total_height: int | None = None, with_stats: bool = False,
                  kernel: Callable = megakernel):
    """Render -> packed int32 (h, w) with one K1 launch
    (pallas_kernel.py:1071-1147).  ``block=(bh, bw)`` with bh*bw == tile
    maps tiles to image rectangles instead of scanline runs; ``row0`` /
    ``total_height`` render rows [row0, row0+height) of a taller image.
    ``kernel`` is what runs K1: the wrapper, or anything with its
    signature (its plain version, or a checking or timing wrapper)."""
    ro = _ray_order(cam, width, height, tile, block, row0, total_height,
                    max_depth)
    out, stats = kernel(scene, ro.params, ro.n_rays, tile,
                        block_tiled=block is not None,
                        with_stats=with_stats)
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


def _bsort_perm(key: torch.Tensor, prefix: int | None) -> torch.Tensor:
    """Permutation of the boundary sort (pallas_kernel.py:1644-1662): sort
    the unique keys of ``key[:prefix]``, leave the suffix in place."""
    n = key.shape[0]
    if prefix is None or not 0 < prefix < n:
        return torch.sort(key).indices
    head = torch.sort(key[:prefix]).indices
    return torch.cat([head, torch.arange(prefix, n, device=key.device)])


def render_pallas_twophase(scene: PallasScene, cam: Camera, width: int,
                           height: int, max_depth: int = MAX_DEPTH,
                           tile: int = DEFAULT_TILE,
                           block: tuple | None = None, row0=0.0,
                           total_height: int | None = None,
                           schedule: tuple = (6,),
                           sort_prefix: tuple | None = None,
                           with_stats: bool = False,
                           kernel: Callable = megakernel):
    """Multi-phase render with survivor compaction between phases
    (pallas_kernel.py:1496-1792).

    Phase k traces every ray to the depth cap ``schedule[k]`` and emits
    its state; the last phase runs to
    ``max_depth``.  At each boundary one sort on the unique key
    ``(dead << 30) | ray_id`` packs the survivors into a prefix (boundary k
    sorts only the first ``sort_prefix[k]`` fraction of the rays, rounded
    to tiles; exact for any survival rate).  Each ray's pixel comes from the
    phase it dies in, accumulated in ``acc_pix``, merged with the last
    phase's pixels and put back in ray order by sorting on the ray id.  The
    image is bit-identical to ``render_pallas``.

    ``with_stats`` also returns exact counter sums, in total and per phase.
    ``kernel`` runs K1, as in ``render_pallas``.
    """
    if sum(schedule) >= max_depth:
        raise ValueError(f"schedule {schedule} must end before max_depth "
                         f"{max_depth}")
    ro = _ray_order(cam, width, height, tile, block, row0, total_height, 0)
    Rp = ro.n_rays
    dev = ro.params.device
    prefs = _sort_prefixes(sort_prefix, len(schedule), Rp, tile)
    depths = list(schedule) + [max_depth - sum(schedule)]

    state_in = acc_pix = idx = None
    phase_stats = []
    for k, depth in enumerate(depths):
        params = ro.params.clone()
        params[13:14].fill_(depth)      # on the device, without a host copy
        st, stats = kernel(scene, params, Rp, tile,
                           block_tiled=(k == 0 and block is not None),
                           state_in=state_in, emit_state=True,
                           with_stats=with_stats)
        if with_stats:
            phase_stats.append(stats)
        pix = pack_pix(st[9], st[10], st[11])
        if k == len(schedule):
            break
        # rays that died this phase hold their colour in rr/rg/rb (zero for
        # the others), so a plain add takes each pixel from one phase
        acc_pix = pix if acc_pix is None else acc_pix + pix
        if idx is None:
            idx = torch.arange(Rp, dtype=torch.int32, device=dev)
        key = ((st[12] <= 0.0).to(torch.int32) << 30) | idx
        perm = _bsort_perm(key, prefs[k])
        key_sorted = key[perm]
        acc_pix = acc_pix[perm]
        idx = key_sorted & ((1 << 30) - 1)
        live = ((key_sorted >> 30) == 0).to(torch.float32)
        state_in = torch.cat([st[:9, perm],
                              st.new_zeros(3, Rp), live[None]])
    # merge the last phase's pixels with the earlier ones, then put them
    # back in ray order by sorting on the original ray id
    merged = torch.where(state_in[12] > 0.0, pix, acc_pix)
    img = _to_image(ro, merged[torch.sort(idx).indices], width, height)
    if not with_stats:
        return img
    per = [_stats_dict(s) for s in phase_stats]
    out = {f"phase_{k}": [p[k] for p in per]
           for k in ("slot_tests", "ray_bounces", "cull_rows")}
    out.update({k: sum(p[k] for p in per)
                for k in ("slot_tests", "ray_bounces", "cull_rows")})
    return img, out


# ---------------------------------------------------------------------------
# record renders (K1d)


def render_pallas_record(scene: PallasScene, cam: Camera, width: int,
                         height: int, max_depth: int = MAX_DEPTH,
                         tile: int = DEFAULT_TILE, with_pay: bool = False,
                         block: tuple | None = None,
                         kernel: Callable = megakernel):
    """Float colours and the per-bounce path record from one K1d launch
    (pallas_kernel.py:1150-1224).

    Returns (colours (h, w, 3) float32, record (max_depth, h*w) int32): per
    step and pixel (row-major), the winner slot ``cluster*128 + lane`` of a
    mirror bounce, -1 a miss, -2 inactive, -3 absorbed.  ``with_pay`` adds
    the raw records in ray order, ``rec`` (D, n_rays) and ``pay``
    (D, 8, n_rays), as ``megakernel`` returns them, for the backward
    replay.  ``block`` and ``kernel`` as in ``render_pallas``."""
    ro = _ray_order(cam, width, height, tile, block, 0.0, None, max_depth)
    st, _, rec, pay = kernel(scene, ro.params, ro.n_rays, tile,
                             block_tiled=block is not None, emit_state=True,
                             record_depth=max_depth, record_pay=with_pay)
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
    ``render_pallas_record``'s."""
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

    recs, pays, states, poskeys = [], [], [], []
    idx = pos                 # each ray's original id, in the current order
    acc = state_in = None     # dead rays' colours (3, Rp); next phase's input
    for k, depth in enumerate(depths):
        st, _, rec, pay = kernel(scene, ro.params, Rp, tile,
                                 block_tiled=(k == 0 and block is not None),
                                 state_in=state_in, emit_state=True,
                                 record_depth=depth, record_pay=True)
        recs.append(rec)
        pays.append(pay)
        if k == len(schedule):
            break
        # a ray dies in one phase; continuations start from zeroed rr/rg/rb,
        # so the sum takes each ray's colour from its phase exactly
        acc = st[9:12] if acc is None else acc + st[9:12]
        key = ((st[12] <= 0.0).to(torch.int32) << 30) | pos
        perm = _bsort_perm(key, prefs[k])
        key_sorted = key[perm]
        poskeys.append(key_sorted)
        acc = acc[:, perm]
        idx = idx[perm]
        states.append(st[:9, perm])
        live = ((key_sorted >> 30) == 0).to(torch.float32)
        state_in = torch.cat([states[-1], st.new_zeros(3, Rp), live[None]])
    # the last phase's colours where its rays were live at entry, then back
    # to ray order by sorting on the original ray id
    merged = torch.where(state_in[12] > 0.0, st[9:12], acc)
    col = merged[:, torch.sort(idx).indices]
    colours = _to_image(ro, col, width, height).permute(1, 2, 0).contiguous()
    return colours, dict(recs=recs, pays=pays, states=states,
                         poskeys=poskeys, schedule=tuple(schedule),
                         sort_prefix_rows=prefs)
