"""The ray mesh: rays sharded over ranks, the scene replicated.

Counterpart of ``raytracers_tpu.parallel.mesh``.  JAX's 1-D device mesh
over the axis 'rays' becomes a ``RayMesh``: this process's rank, the
number of ranks, the ``torch.distributed`` process group that joins them
and this rank's device.

* Every rank traces its contiguous slice of the rays (``trace_slab``) or
  renders a horizontal slab of the image (``render_pallas_slab``).  A
  rank's work is a plain function of (rank, size), so one process can run
  every rank of an n-rank mesh, as the JAX tests run 8 virtual devices.
* The scene is replicated: every rank holds all of it.
* The mesh functions end in one ``all_gather`` of the slabs, so that every
  rank returns the whole image.  JAX needs no collective there: its
  sharded result is one global array, assembled only when it is read.
  The only other collective is the train step's all-reduce of the loss and
  the gradients (``grad/inverse.py``).
* Under ``utils.trace.counting()`` each collective adds one call and the
  bytes this rank contributes to ``mesh.allreduce_calls`` and
  ``mesh.allreduce_bytes``, by caller: ``train`` (``all_sum``, the
  trainers' all-reduce) and ``gather`` (``all_gather``).

A ``RayMesh`` without a process group runs all of its ranks in this
process, in rank order: its gather concatenates their slabs and its
all-reduce sums their tensors.  ``ray_mesh()`` without a process group is
the one-rank mesh.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

from ..geometry import MAX_DEPTH
from ..image import colour_to_pixel
from ..render.api import PreparedScene, _oracle, pallas_config
from ..render.megakernel import render_pallas, render_pallas_twophase
from ..render.tracer import primary_rays, trace
from ..utils.platform import resolve_device
from ..utils.trace import count, span


class RayMesh(NamedTuple):
    rank: int
    size: int
    group: object | None        # a torch.distributed ProcessGroup
    device: torch.device


def ray_mesh(group=None, device=None) -> RayMesh:
    """The mesh of ``group`` (default: the initialised default group, if
    any) at this process's rank, or without a process group the one-rank
    mesh; ``device`` as ``resolve_device`` takes it (default: the card)."""
    device = resolve_device(device)
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        return RayMesh(0, 1, None, device)
    return RayMesh(dist.get_rank(group), dist.get_world_size(group), group,
                   device)


def _count(caller: str, tensors) -> None:
    """One collective of ``caller`` and the bytes of ``tensors``, this
    rank's share, under ``counting()``."""
    count("mesh.allreduce_calls", 1, caller)
    count("mesh.allreduce_bytes",
          sum(t.numel() * t.element_size() for t in tensors), caller)


def all_gather(mesh: RayMesh, body: Callable[[int], torch.Tensor]):
    """``body(rank)`` of every rank, concatenated along axis 0 in rank
    order, on every rank."""
    if mesh.group is None:
        parts = [body(r) for r in range(mesh.size)]
        _count("gather", parts[:1])
        return torch.cat(parts)
    part = body(mesh.rank).contiguous()
    _count("gather", [part])
    parts = [torch.empty_like(part) for _ in range(mesh.size)]
    dist.all_gather(parts, part, group=mesh.group)
    return torch.cat(parts)


def all_sum(mesh: RayMesh, body: Callable[[int], list]) -> list:
    """The sum over ranks of each float32 tensor of ``body(rank)``, on
    every rank: one all-reduce of the tensors flattened into one buffer.
    The reduction, and not ``body``, runs under the span ``rt.allreduce``:
    the flatten, the all-reduce and the split, or without a process group
    the sum of the ranks' tensors in rank order."""
    if mesh.group is None:
        parts = [body(r) for r in range(mesh.size)]
        with span("rt.allreduce"):
            _count("train", parts[0])
            total = parts[0]
            for part in parts[1:]:
                total = [a + b for a, b in zip(total, part)]
            return total
    part = body(mesh.rank)
    with span("rt.allreduce"):
        _count("train", part)
        flat = torch.cat([t.reshape(-1) for t in part])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
        out, k = [], 0
        for t in part:
            out.append(flat[k:k + t.numel()].reshape(t.shape))
            k += t.numel()
        return out


def _pad_to(x, r):
    """Pad axis 0 to r rows by cycling the input (padding rays are traced
    and discarded); cycling covers r > 2 * len(x), where a tiny image meets
    many ranks."""
    n = x.shape[0]
    if n == r:
        return x
    reps = -(-r // n)
    return x.repeat(reps, *(1,) * (x.ndim - 1))[:r]


def trace_slab(prepared: PreparedScene, origins, dirs, rank: int, size: int,
               mode: str = "bvh", max_depth: int = MAX_DEPTH):
    """Rank ``rank``'s share of ``trace_sharded``: colours (R', 3) of its
    contiguous slice of the rays, padded to a multiple of ``size``."""
    per = -(-origins.shape[0] // size)
    rows = slice(rank * per, (rank + 1) * per)
    o = _pad_to(origins, per * size)[rows]
    d = _pad_to(dirs, per * size)[rows]
    return trace(_oracle(prepared, mode), prepared.spheres, o, d, max_depth)


def trace_sharded(prepared: PreparedScene, origins, dirs, mesh: RayMesh,
                  mode: str = "bvh", max_depth: int = MAX_DEPTH):
    """Trace a ray batch sharded over the mesh -> colours (R, 3)."""
    return all_gather(mesh, lambda r: trace_slab(
        prepared, origins, dirs, r, mesh.size, mode,
        max_depth))[:origins.shape[0]]


def _slab_config(scene, height: int, width: int, size: int,
                tile: int | None = None, block: tuple | None = None,
                schedule: tuple | None = None,
                sort_prefix: tuple | None = None):
    """The sharded render's (tile, block, schedule, sort_prefix, rows_per)
    (mesh.py:321-345): the scene class's render config, but (32, 16)
    blocks of 512 rays where the class's block would pad a slab beyond its
    real rows; slabs of ``rows_per`` rows, block-aligned."""
    dtile, dblock, dsched, dpref = pallas_config(scene.n_clusters)
    if tile is None or block is None:
        if height < size * dblock[0] or width < dblock[1]:
            tile, block = 512, (32, 16)
        else:
            tile, block = dtile, dblock
    if schedule is None:
        schedule = dsched
        if sort_prefix is None:
            sort_prefix = dpref
    bh = block[0] if block is not None else 1
    rows_per = -(-height // (size * bh)) * bh
    return tile, block, tuple(schedule), sort_prefix, rows_per


def render_pallas_slab(scene, cam, height: int, width: int, rank: int,
                       size: int, max_depth: int = MAX_DEPTH,
                       tile: int | None = None, block: tuple | None = None,
                       schedule: tuple | None = None,
                       sort_prefix: tuple | None = None):
    """Rank ``rank``'s slab of ``render_pallas_sharded``: rows [rank *
    rows_per, (rank + 1) * rows_per) of the packed image, the kernel's row
    offset ``row0`` a runtime parameter.  Deep renders (``max_depth >=
    16``) compact the slab's survivors as the unsharded ``render`` does;
    per-ray arithmetic does not depend on the tiling, so the slab is
    bit-identical to those rows of the one-rank render."""
    tile, block, schedule, sort_prefix, rows_per = _slab_config(
        scene, height, width, size, tile, block, schedule, sort_prefix)
    kw = dict(max_depth=max_depth, tile=tile, block=block,
              row0=float(rank * rows_per), total_height=height)
    if max_depth >= 16 and sum(schedule) < max_depth:
        return render_pallas_twophase(scene, cam, width, rows_per,
                                      schedule=schedule,
                                      sort_prefix=sort_prefix, **kw)
    return render_pallas(scene, cam, width, rows_per, **kw)


def render_pallas_sharded(scene, cam, height: int, width: int,
                          mesh: RayMesh | None = None,
                          max_depth: int = MAX_DEPTH,
                          tile: int | None = None,
                          block: tuple | None = None,
                          schedule: tuple | None = None,
                          sort_prefix: tuple | None = None):
    """Sharded megakernel render -> packed int32 (h, w) on every rank:
    each rank renders its slab (``render_pallas_slab``), then one
    ``all_gather``.  ``scene`` is a ``PallasScene``; ``mesh`` defaults to
    ``ray_mesh`` on the camera's device."""
    mesh = mesh if mesh is not None else ray_mesh(device=cam.origin.device)
    return all_gather(mesh, lambda r: render_pallas_slab(
        scene, cam, height, width, r, mesh.size, max_depth, tile, block,
        schedule, sort_prefix))[:height]


def render_sharded(prepared: PreparedScene, height: int, width: int,
                   mesh: RayMesh | None = None, mode: str = "bvh",
                   max_depth: int = MAX_DEPTH):
    """Full-image sharded render -> packed int32 (h, w) on every rank."""
    mesh = (mesh if mesh is not None
            else ray_mesh(device=prepared.cam.origin.device))
    if mode == "pallas":
        if prepared.pallas is None:
            raise ValueError("prepare_scene(..., with_pallas=True) required "
                             "for mode='pallas'")
        return render_pallas_sharded(prepared.pallas, prepared.cam, height,
                                     width, mesh, max_depth)
    origins, dirs = primary_rays(prepared.cam, width, height)
    colours = trace_sharded(prepared, origins, dirs, mesh, mode, max_depth)
    return colour_to_pixel(colours.reshape(height, width, 3))
