"""Lane-parallel stackless BVH traversal (the XLA path).

Counterpart of ``raytracers_tpu.bvh.traverse``.  Every ray advances its own
node id one step per iteration of one shared loop, which runs until every
ray has parked at the -1 sentinel (one ``any()`` a step, as the JAX
package's ``lax.while_loop`` tests its condition).  The threaded skip-link
layout makes each step a single node visit:

    inner node:  slab test in (T_MIN, best_t) -> hit ? left child : skip
    leaf node:   the cluster's K spheres in (t_min, best_t) -> skip

Ties go to the first sphere of a leaf (``argmin`` takes the first minimum,
as JAX's does) and to the first leaf visited (strict ``<``).  Plain
PyTorch on any device: the JAX package computes this walk outside any
Pallas kernel.
"""
from __future__ import annotations

import functools

import torch

from ..geometry import SCENE_EPSILON, T_MAX, T_MIN, aabb_hit, sphere_hit_t
from ..vec import Aabb
from .lbvh import Bvh


def closest_hit_bvh(bvh: Bvh, origins, dirs, t_min=SCENE_EPSILON,
                    t_max=T_MAX):
    """(R,3) rays -> (original sphere index (R,) int64, t (R,) f32);
    -1 / +inf on a miss."""
    R = origins.shape[0]
    dev = origins.device
    n_inner = bvh.n_inner
    K = bvh.leaf_size
    left, skip = bvh.left.long(), bvh.skip.long()
    slots = torch.arange(K, device=dev)

    cur = torch.zeros(R, dtype=torch.int64, device=dev)   # the root
    best_t = torch.full((R,), t_max, dtype=torch.float32, device=dev)
    best_i = torch.full((R,), -1, dtype=torch.int64, device=dev)
    while bool((cur >= 0).any()):
        done = cur < 0
        is_leaf = cur >= n_inner
        safe_cur = torch.where(done, 0, cur)

        # inner case: slab test against the node AABB
        ii = safe_cur.clamp(0, n_inner - 1)
        box = Aabb(bvh.node_min[ii], bvh.node_max[ii])
        box_hit = aabb_hit(box, origins, dirs, T_MIN, best_t)

        # leaf case: the cluster's K spheres
        base = (safe_cur - n_inner).clamp(0, bvh.n_leaves - 1) * K
        sidx = base[:, None] + slots[None, :]                  # (R, K)
        ts = sphere_hit_t(origins[:, None, :], dirs[:, None, :],
                          bvh.spheres.center[sidx],
                          bvh.spheres.radius[sidx], t_min, best_t[:, None])
        k_t, k_best = torch.min(ts, dim=1)
        improves = is_leaf & ~done & (k_t < best_t)
        best_t = torch.where(improves, k_t, best_t)
        best_i = torch.where(improves, base + k_best, best_i)

        # advance
        nxt = torch.where(is_leaf | ~box_hit, skip[safe_cur], left[ii])
        cur = torch.where(done, -1, nxt)
    hit = best_i >= 0
    orig = torch.where(hit, bvh.order[best_i.clamp(min=0)].long(), -1)
    return orig, torch.where(hit, best_t, float("inf"))


def make_closest_hit(bvh: Bvh):
    """Adapter matching the tracer's closest-hit contract."""
    return functools.partial(closest_hit_bvh, bvh)
