"""Differentiable rendering through the megakernel: the fwd+bwd engine.

Counterpart of ``raytracers_tpu.grad.pallas_diff``.
``make_render_pallas_diff`` builds ``f(spheres, cam) -> colours (h, w, 3)``,
a ``torch.autograd.Function`` over (centre, radius, colour, origin, llc,
horizontal, vertical):

* forward: K1 in record mode (K1d) renders float colours and records, per
  step and ray, the winner's slot and fields, in one launch or in the
  phases of a compaction schedule (``render/megakernel.py``);
* backward, ``backward="pallas"`` (the default): K2 (``grad/replay_bwd.py``)
  replays each segment deepest first; the 9-row cotangent carry crosses
  each boundary back by inverting the boundary's permutation (its poskeys,
  prefix-aware); the slot tables of the segments are summed and scattered
  to sphere order through the layout's ``order`` table with ``index_add_``
  (padding slots dropped); the camera gradient is the vector-Jacobian
  product of ``primary_rays``;
* backward, ``backward="xla"``: the plain torch replay of the oracle
  (``grad/diff_render.replay_paths``) under autograd, from the forward's
  record mapped to sphere indices; optionally in ray chunks
  (``bwd_chunks``), the rays sorted by path depth first
  (``sort_by_depth``), and skipping all-dead step groups (``skip_dead``).

The scene is laid out without ``sort_origin`` (pallas_diff.py:343,357), so
the recorded slots refer to the unsorted layout, as in the JAX package; the
K2 engine lays it out at ``cluster_width`` (32, 64 or 128).  Winner slots
are ``cluster*128 + lane`` at any width, so K2 and the slot table (C*128
slots) are unchanged by it.  Gradients are exact away from visibility
discontinuities: the discrete path is held fixed (grad/diff_render.py).
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.autograd.function import once_differentiable

from ..geometry import MAX_DEPTH, Camera, Spheres
from ..render.megakernel import (_ray_order, _to_image, build_pallas_scene,
                                 megakernel, render_pallas_record,
                                 render_pallas_record_twophase)
from ..render.tracer import primary_rays
from ..utils.trace import counters, span, spanned
from .diff_render import (EV_ABSORB, EV_BOUNCE, EV_INACTIVE, EV_MISS,
                          replay_paths)
from .replay_bwd import N_CARRY, replay_bwd

_POS_MASK = (1 << 30) - 1


def _rec_to_path(rec_orig):
    """(D, R) record in sphere indices -> (idxs, events) for replay_paths."""
    idxs = rec_orig.clamp(min=0)
    events = torch.where(
        rec_orig >= 0, EV_BOUNCE,
        torch.where(rec_orig == -1, EV_MISS,
                    torch.where(rec_orig == -3, EV_ABSORB, EV_INACTIVE)))
    return idxs, events.to(torch.uint8)


def _camera_vjp(cam: Camera, width, height, go, gd):
    """Cotangents of the primary rays' origins and directions (R, 3) ->
    the camera's four fields, through ``primary_rays``."""
    with torch.enable_grad():
        leaves = Camera(*(t.detach().requires_grad_(True) for t in cam))
        o, d = primary_rays(leaves, width, height)
        return torch.autograd.grad((o, d), leaves, (go, gd))


class _KernelEngine:
    """backward="pallas": K1d forward, K2 backward, segment by segment."""

    def __init__(self, width, height, max_depth, tile, block, schedule,
                 sort_prefix, cluster_width, fwd_kernel, bwd_kernel):
        self.width, self.height, self.max_depth = width, height, max_depth
        self.tile, self.block = tile, block
        self.schedule, self.sort_prefix = schedule, sort_prefix
        self.cluster_width = cluster_width
        self.fwd_kernel, self.bwd_kernel = fwd_kernel, bwd_kernel

    @spanned("rt.grad.forward")
    def forward(self, spheres: Spheres, cam: Camera):
        scene = build_pallas_scene(spheres, cluster_width=self.cluster_width)
        kw = dict(max_depth=self.max_depth, tile=self.tile, block=self.block,
                  kernel=self.fwd_kernel)
        if self.schedule:
            colours, aux = render_pallas_record_twophase(
                scene, cam, self.width, self.height, schedule=self.schedule,
                sort_prefix=self.sort_prefix, **kw)
        else:
            colours, _, rec, pay = render_pallas_record(
                scene, cam, self.width, self.height, with_pay=True, **kw)
            aux = dict(recs=[rec], pays=[pay], states=[], poskeys=[],
                       sort_prefix_rows=[])
        return colours, (aux, scene.order)

    def _gflat(self, g, n_rays):
        """Image cotangent (h, w, 3) -> (3, n_rays) in the ray order."""
        w, h = self.width, self.height
        g = g.permute(2, 0, 1)
        if self.block is None:
            flat = g.reshape(3, -1)
            return torch.cat([flat, flat.new_zeros(3, n_rays - w * h)], 1)
        bh, bw = self.block
        hp, wp = -(-h // bh) * bh, -(-w // bw) * bw
        gpad = g.new_zeros(3, hp, wp)
        gpad[:, :h, :w] = g
        return (gpad.reshape(3, hp // bh, bh, wp // bw, bw)
                .permute(0, 1, 3, 2, 4).reshape(3, n_rays))

    @spanned("rt.grad.backward")
    def backward(self, res, spheres: Spheres, cam: Camera, g):
        aux, order = res
        w, h = self.width, self.height
        ro = _ray_order(cam, w, h, self.tile, self.block, 0.0, None,
                        self.max_depth)
        Rp = ro.n_rays
        S = order.numel()
        recs, pays, states = aux["recs"], aux["pays"], aux["states"]
        poskeys, prefs = aux["poskeys"], aux["sort_prefix_rows"]
        m = len(poskeys)                                    # boundaries

        def prefix(j):
            B = prefs[j]
            return B if B is not None and 0 < B < Rp else None

        # the image cotangent in each segment's ray order: the poskeys' low
        # bits are the source positions of each boundary's sort
        with span("rt.reorder"):
            gseg = [self._gflat(g, Rp)]
            for j in range(m):
                pos, B = poskeys[j] & _POS_MASK, prefix(j)
                if B is None:
                    gseg.append(gseg[-1][:, pos])
                else:
                    gseg.append(torch.cat([gseg[-1][:, pos[:B]],
                                           gseg[-1][:, B:]], 1))
        c = counters()
        tabs = []
        carry = None
        for k in range(m, -1, -1):
            with span(f"rt.segment{k}"):
                gcot = torch.cat([gseg[k], carry if carry is not None
                                  else gseg[k].new_zeros(N_CARRY, Rp)])
                tab_k, cot, _ = self.bwd_kernel(
                    ro.params, recs[k], pays[k], gcot, tile=self.tile,
                    block_tiled=(k == 0 and self.block is not None),
                    state_rows=None if k == 0 else states[k - 1],
                    reduce_slots=S)
            if c is not None:
                c.add("k2.bounces", (recs[k] >= 0).sum(), f"segment{k}")
            tabs.append(tab_k)
            if k == 0:
                break
            # back across boundary k-1: the ray at position i of segment k
            # came from position pos[i] of segment k-1
            with span(f"rt.carry{k - 1}"):
                pos, B = (poskeys[k - 1] & _POS_MASK).long(), prefix(k - 1)
                carry = (cot.clone() if B is not None
                         else torch.empty_like(cot))
                if B is None:
                    carry[:, pos] = cot
                else:
                    carry[:, pos[:B]] = cot[:, :B]

        with span("rt.scatter"):
            # the segments' tables summed deepest first
            tab = tabs[0]
            for tab_k in tabs[1:]:
                tab = tab + tab_k
            n = spheres.center.shape[0]
            ordv = order.reshape(-1).long()
            tgt = torch.where(ordv >= 0, ordv, n)            # padding: dropped
            gtab = tab.new_zeros(n + 1, 7).index_add_(0, tgt, tab)[:n]
            gs = (gtab[:, 0:3].contiguous(), gtab[:, 3].contiguous(),
                  gtab[:, 4:7].contiguous())
        with span("rt.camera"):
            rays = _to_image(ro, cot, w, h).reshape(6, -1)  # row-major
            gcam = _camera_vjp(cam, w, h, rays[0:3].T, rays[3:6].T)
        return gs, gcam


class _ReplayEngine:
    """backward="xla": K1d forward, the oracle's replay under autograd, in
    ray chunks (pallas_diff.py:133-213)."""

    def __init__(self, width, height, max_depth, tile, gather, remat,
                 bwd_chunks, sort_by_depth, skip_dead, fwd_kernel):
        self.width, self.height, self.max_depth = width, height, max_depth
        self.tile, self.gather, self.remat = tile, gather, remat
        self.bwd_chunks, self.sort_by_depth = bwd_chunks, sort_by_depth
        self.skip_dead = skip_dead
        self.fwd_kernel = fwd_kernel

    def forward(self, spheres: Spheres, cam: Camera):
        scene = build_pallas_scene(spheres)
        colours, rec = render_pallas_record(
            scene, cam, self.width, self.height, max_depth=self.max_depth,
            tile=self.tile, kernel=self.fwd_kernel)
        # winner slots -> sphere indices (padding slots have radius 0 and
        # never win, so order >= 0 wherever rec >= 0)
        order = scene.order.reshape(-1)
        rec_orig = torch.where(rec >= 0, order[rec.clamp(min=0).long()], rec)
        return colours, rec_orig

    def backward(self, rec_orig, spheres: Spheres, cam: Camera, g):
        """The replay's vector-Jacobian product chunk by chunk, summing the
        sphere gradients; then the rays' cotangents through the camera.

        ``sort_by_depth`` (with ``bwd_chunks`` > 1) first permutes the rays
        by descending path depth on the unique key ``(D - depth) * R + id``,
        with one gather of the stacked (R, 9 + D) rows (the record's int32
        columns ride bitcast to float32), so each chunk is depth-homogeneous
        and ``skip_dead`` (default: on exactly when sorted) skips its dead
        step groups; the ray cotangents are put back by the inverse
        permutation.  The last chunk is padded with inert rays: direction
        (1, 1, 1) (a zero one gives 0/0 in the replay), EV_INACTIVE events
        and a zero cotangent."""
        D = self.max_depth
        o, d = primary_rays(cam, self.width, self.height)
        R = o.shape[0]
        gflat = g.reshape(-1, 3)
        n_chunks = max(1, self.bwd_chunks)
        perm = None
        if self.sort_by_depth and n_chunks > 1:
            depth = (rec_orig != -2).sum(dim=0)
            key = (D - depth) * R + torch.arange(R, device=o.device)
            perm = torch.sort(key).values % R
            stacked = torch.cat([o, d, gflat,
                                 rec_orig.T.contiguous().view(torch.float32)],
                                dim=1)                        # (R, 9 + D)
            rows = stacked[perm]
            o, d, gflat = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
            rec_orig = rows[:, 9:].contiguous().view(torch.int32).T
        idxs, events = _rec_to_path(rec_orig)
        skip = (perm is not None) if self.skip_dead is None else self.skip_dead

        ck = -(-R // n_chunks)
        pad = ck * n_chunks - R
        if pad:
            o = torch.cat([o, o.new_zeros(pad, 3)])
            d = torch.cat([d, d.new_ones(pad, 3)])
            gflat = torch.cat([gflat, gflat.new_zeros(pad, 3)])
            idxs = torch.cat([idxs, idxs.new_zeros(D, pad)], dim=1)
            events = torch.cat([events, events.new_full((D, pad),
                                                         EV_INACTIVE)], dim=1)
        gs, go, gd = None, [], []
        for c in range(n_chunks):
            cs = slice(c * ck, (c + 1) * ck)
            with torch.enable_grad():
                sph = Spheres(*(t.detach().requires_grad_(True)
                                for t in spheres))
                oc = o[cs].detach().requires_grad_(True)
                dc = d[cs].detach().requires_grad_(True)
                col = replay_paths(sph, oc, dc, idxs[:, cs], events[:, cs],
                                   gather=self.gather, remat=self.remat,
                                   skip_dead=skip)
                grads = torch.autograd.grad(col, [*sph, oc, dc], gflat[cs],
                                            allow_unused=True)
            grads = [torch.zeros_like(x) if gx is None else gx
                     for gx, x in zip(grads, [*sph, oc, dc])]
            gs = (grads[:3] if gs is None
                  else [a + b for a, b in zip(gs, grads[:3])])
            go.append(grads[3])
            gd.append(grads[4])
        go, gd = torch.cat(go)[:R], torch.cat(gd)[:R]
        if perm is not None:
            inv = torch.empty_like(perm)
            inv[perm] = torch.arange(R, device=perm.device)
            god = torch.cat([go, gd], dim=1)[inv]
            go, gd = god[:, 0:3], god[:, 3:6]
        return gs, _camera_vjp(cam, self.width, self.height, go, gd)


class _RenderDiff(torch.autograd.Function):
    @staticmethod
    def forward(ctx, engine, center, radius, color, origin, llc, horizontal,
                vertical):
        colours, res = engine.forward(Spheres(center, radius, color),
                                      Camera(origin, llc, horizontal,
                                             vertical))
        ctx.engine, ctx.res = engine, res
        ctx.save_for_backward(center, radius, color, origin, llc,
                              horizontal, vertical)
        return colours

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x = ctx.saved_tensors
        gs, gcam = ctx.engine.backward(ctx.res, Spheres(*x[:3]),
                                       Camera(*x[3:]), g.contiguous())
        ctx.res = None
        return (None, *gs, *gcam)


def make_render_pallas_diff(width: int, height: int,
                            max_depth: int = MAX_DEPTH, tile: int = 512,
                            bwd_chunks: int = 1, gather: str = "onehot",
                            remat: bool = True, sort_by_depth: bool = False,
                            skip_dead: bool | None = None,
                            backward: str = "pallas",
                            block: tuple | None = None,
                            phase1_depth: int | None = None,
                            schedule: tuple | None = None,
                            sort_prefix: tuple | None = None,
                            cluster_width: int | None = None,
                            fwd_kernel: Callable = megakernel,
                            bwd_kernel: Callable = replay_bwd):
    """Build a differentiable ``f(spheres, cam) -> colours (h, w, 3)`` whose
    forward is K1 in record mode; it runs where the tensors lie.

    ``backward="pallas"`` runs K2.  ``block=(bh, bw)`` (bh * bw == tile)
    takes image-block ray order for both passes; ``schedule`` (or
    ``phase1_depth=p``, meaning ``(p,)``) and ``sort_prefix`` split both
    passes into segments with survivor compaction between them, as
    ``render_pallas_record_twophase`` does; ``cluster_width`` (32, 64 or
    the default 128) is the layout's cluster width, built every step.

    ``backward="xla"`` replays with the oracle (``gather`` and ``remat`` as
    in ``replay_paths``) at cluster width 128 and ignores ``block``, the
    schedule and ``cluster_width``, as the JAX package does.
    ``bwd_chunks`` splits its replay into that many ray chunks, which
    bounds its memory; ``sort_by_depth`` (with ``bwd_chunks`` > 1) sorts
    the rays by path depth before chunking, and ``skip_dead`` (default: on
    exactly when sorted) skips the step groups where a chunk has no live
    ray (``_ReplayEngine.backward``).  The JAX package measured both as
    losses on the TPU; here they are the same function, chunked.

    ``fwd_kernel`` and ``bwd_kernel`` are what run K1d and K2: the
    wrappers, or anything with their signatures (their plain versions, or a
    checking or timing wrapper)."""
    if backward == "pallas":
        if schedule is None and phase1_depth:
            schedule = (phase1_depth,)
        engine = _KernelEngine(width, height, max_depth, tile, block,
                               schedule, sort_prefix, cluster_width,
                               fwd_kernel, bwd_kernel)
    elif backward == "xla":
        engine = _ReplayEngine(width, height, max_depth, tile, gather, remat,
                               bwd_chunks, sort_by_depth, skip_dead,
                               fwd_kernel)
    else:
        raise ValueError(f"unknown backward {backward!r}")

    def render_diff(spheres: Spheres, cam: Camera):
        return _RenderDiff.apply(engine, *spheres, *cam)

    return render_diff
