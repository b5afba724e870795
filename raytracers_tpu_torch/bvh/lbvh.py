"""LBVH construction: Morton sort, clustered leaves, Karras tree, refit,
skip links.

Counterpart of ``raytracers_tpu.bvh.lbvh``, field for field:

* ``_sort_by_morton`` / ``_pad_spheres`` / ``build_clusters``: each leaf
  holds ``leaf_size`` consecutive Morton-sorted spheres, padded with
  radius-0 spheres (the megakernel's layout needs only this);
* ``build_bvh`` adds the Karras radix tree (``radix_tree.py``), the AABB
  refit as range-min/max queries over each node's contiguous leaf range
  (``_refit_rmq``) and the skip links in closed form (``_skip_links_rmq``);
  the levelwise sweeps ``_refit`` and ``_skip_links`` stay as their oracles.

The build runs on the device of the spheres; every loop bound is static,
so it never waits on the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import Spheres, sphere_aabb
from ..vec import centre
from .morton import morton_codes
from .radix_tree import RadixTree, build_radix_tree, floor_log2


def _sort_by_morton(spheres: Spheres):
    """Stable sort of the spheres by Morton code of their AABB centres.
    Returns (sorted_spheres, perm int32, sorted_codes int64); equal codes
    keep their input order, as in the JAX package's stable ``lax.sort``."""
    codes = morton_codes(centre(sphere_aabb(spheres)))
    sorted_codes, perm = torch.sort(codes, stable=True)
    sorted_spheres = Spheres(*(f[perm] for f in spheres))
    return sorted_spheres, perm.to(torch.int32), sorted_codes


def _pad_spheres(spheres: Spheres, order, m: int):
    """Pad sorted spheres to m entries with radius-0 never-hit spheres
    co-located with the last real sphere (keeps cluster AABBs tight)."""
    pad = m - spheres.center.shape[0]
    if pad == 0:
        return spheres, order
    center = torch.cat([spheres.center,
                        spheres.center[-1:].expand(pad, 3)], dim=0)
    radius = torch.cat([spheres.radius, spheres.radius.new_zeros(pad)])
    color = torch.cat([spheres.color, spheres.color.new_zeros(pad, 3)])
    order = torch.cat([order, order.new_full((pad,), -1)])
    return Spheres(center, radius, color), order


class Clusters(NamedTuple):
    """Morton-sorted leaf clustering without the radix tree."""
    spheres: Spheres            # (M,...) Morton-sorted, radius-0 padded
    order: torch.Tensor         # (M,) int32 original sphere index, -1 padding
    leaf_min: torch.Tensor      # (C, 3) cluster AABBs
    leaf_max: torch.Tensor      # (C, 3)

    @property
    def n_leaves(self) -> int:
        return self.leaf_min.shape[0]


def build_clusters(spheres: Spheres, leaf_size: int = 1) -> Clusters:
    """Morton sort + cluster + leaf AABBs (lbvh.py:239-258)."""
    n = spheres.center.shape[0]
    if n < 2:
        raise ValueError("build_clusters requires at least 2 spheres")
    n_leaves = -(-n // leaf_size)
    if n_leaves < 2:
        leaf_size = -(-n // 2)
        n_leaves = -(-n // leaf_size)
    m = n_leaves * leaf_size

    sorted_spheres, perm, _ = _sort_by_morton(spheres)
    sorted_spheres, order = _pad_spheres(sorted_spheres, perm, m)

    sb = sphere_aabb(sorted_spheres)
    leaf_min = sb.min.reshape(n_leaves, leaf_size, 3).amin(dim=1)
    leaf_max = sb.max.reshape(n_leaves, leaf_size, 3).amax(dim=1)
    return Clusters(spheres=sorted_spheres, order=order,
                    leaf_min=leaf_min, leaf_max=leaf_max)


class Bvh(NamedTuple):
    """Flat SoA LBVH over clustered sphere leaves.

    C clusters (leaves) of K = leaf_size spheres, M = C*K padded spheres.
    Extended node ids: inner i in [0, C-1), leaf c at C-1+c; ``-1`` is the
    traversal-done sentinel.  Index fields are int32.
    """
    spheres: Spheres            # (M,...) Morton-sorted, radius-0 padded
    order: torch.Tensor         # (M,) original sphere index, -1 padding
    left: torch.Tensor          # (C-1,) encoded child ids
    right: torch.Tensor         # (C-1,)
    node_min: torch.Tensor      # (C-1, 3) inner AABBs
    node_max: torch.Tensor      # (C-1, 3)
    leaf_min: torch.Tensor      # (C, 3) cluster AABBs
    leaf_max: torch.Tensor      # (C, 3)
    skip: torch.Tensor          # (2C-1,) miss link per extended node id
    parent: torch.Tensor        # (C-1,) parent inner id (root: -1)
    leaf_parent: torch.Tensor   # (C,) parent inner id

    @property
    def n_leaves(self) -> int:
        return self.leaf_min.shape[0]

    @property
    def n_inner(self) -> int:
        return self.left.shape[0]

    @property
    def leaf_size(self) -> int:
        return self.spheres.center.shape[0] // self.n_leaves


def _refit(tree: RadixTree, leaf_min, leaf_max, sweeps: int):
    """Levelwise AABB refit (futhark/bvh.fut:47-58): each sweep recomputes
    every inner AABB from its children's current AABBs; after ``sweeps``
    (max inner depth + 1) passes all are exact."""
    n_inner = tree.n_inner
    left, right = tree.left.long(), tree.right.long()
    node_min = leaf_min.new_zeros(n_inner, 3)
    node_max = leaf_max.new_zeros(n_inner, 3)
    for _ in range(int(sweeps)):
        ext_min = torch.cat([node_min, leaf_min])
        ext_max = torch.cat([node_max, leaf_max])
        node_min = torch.minimum(ext_min[left], ext_min[right])
        node_max = torch.maximum(ext_max[left], ext_max[right])
    return node_min, node_max


def _refit_rmq(first, last, leaf_min, leaf_max):
    """AABB refit as range-min/max queries: a Karras node covers the
    contiguous leaf range [first, last], so its AABB is an overlapping
    two-window query into log n sparse tables built by static shifts."""
    n = leaf_min.shape[0]
    kmax = max(1, int(n - 1).bit_length())

    def tables(x, pad, op):
        rows = [x]
        cur = x
        for k in range(1, kmax + 1):
            h = 1 << (k - 1)
            if h < n:
                shifted = torch.cat([cur[h:], x.new_full((h, 3), pad)])
            else:
                shifted = x.new_full((n, 3), pad)
            cur = op(cur, shifted)
            rows.append(cur)
        return torch.stack(rows).reshape((kmax + 1) * n, 3)

    tmin = tables(leaf_min, float("inf"), torch.minimum)
    tmax = tables(leaf_max, -float("inf"), torch.maximum)
    first, last = first.long(), last.long()
    kq = floor_log2(last - first + 1)             # leaf count >= 2
    lo = kq * n + first
    hi = kq * n + (last + 1 - (torch.ones_like(kq) << kq))
    return (torch.minimum(tmin[lo], tmin[hi]),
            torch.maximum(tmax[lo], tmax[hi]))


def _skip_links_rmq(tree: RadixTree):
    """Threaded-BVH miss links in closed form: miss(v) is the highest node
    whose leaf range starts at last(v) + 1 (ranges starting at one leaf are
    nested, so the top of each chain is unique).  The scatter writes each
    chain top to its leaf slot and every other node to a dummy slot of its
    own, so no slot is written twice."""
    n_inner = tree.n_inner
    n = tree.n_leaves
    dev = tree.first.device
    parent = tree.parent.long()
    first = tree.first.long()
    pfirst = first[parent.clamp(min=0)]
    biggest = (parent < 0) | (pfirst != first)
    inner = torch.arange(n_inner, dtype=torch.int64, device=dev)
    # H[x] = encoded id of the highest node starting at leaf x (default:
    # leaf x itself); slots n.. are the dummies
    H = torch.cat([n_inner + torch.arange(n, dtype=torch.int64, device=dev),
                   torch.zeros(n_inner, dtype=torch.int64, device=dev)])
    H[torch.where(biggest, first, n + inner)] = inner
    ext_last = torch.cat([tree.last.long(),
                          torch.arange(n, dtype=torch.int64, device=dev)])
    x = ext_last + 1
    return torch.where(x >= n, -1, H[x.clamp(max=n - 1)]).to(torch.int32)


def _skip_links(tree: RadixTree, sweeps: int):
    """Threaded-BVH miss links by levelwise propagation of
    miss(v) = right(parent) if v is the left child, else miss(parent);
    miss(root) = -1.  Each sweep finalises one more level."""
    n_inner = tree.n_inner
    n_ext = n_inner + tree.n_leaves
    dev = tree.left.device
    ext_parent = torch.cat([tree.parent, tree.leaf_parent]).long()
    self_id = torch.arange(n_ext, dtype=torch.int64, device=dev)
    safe_p = ext_parent.clamp(min=0)
    is_left = tree.left.long()[safe_p] == self_id
    sibling = tree.right.long()[safe_p]
    miss = torch.full((n_ext,), -1, dtype=torch.int64, device=dev)
    for _ in range(int(sweeps)):
        miss = torch.where(ext_parent < 0, -1,
                           torch.where(is_left, sibling, miss[safe_p]))
    return miss.to(torch.int32)


def build_bvh(spheres: Spheres, leaf_size: int = 1) -> Bvh:
    """Build the LBVH (lbvh.py:261-291) on the device of ``spheres``."""
    n = spheres.center.shape[0]
    if n < 2:
        raise ValueError("build_bvh requires at least 2 spheres")
    n_leaves = -(-n // leaf_size)
    if n_leaves < 2:
        leaf_size = -(-n // 2)
        n_leaves = -(-n // leaf_size)
    m = n_leaves * leaf_size

    sorted_spheres, perm, sorted_codes = _sort_by_morton(spheres)
    sorted_spheres, order = _pad_spheres(sorted_spheres, perm, m)

    # cluster AABBs: radius-0 padding cannot extend a cluster's bounds
    sb = sphere_aabb(sorted_spheres)
    leaf_min = sb.min.reshape(n_leaves, leaf_size, 3).amin(dim=1)
    leaf_max = sb.max.reshape(n_leaves, leaf_size, 3).amax(dim=1)

    cluster_codes = sorted_codes[::leaf_size][:n_leaves]
    tree = build_radix_tree(cluster_codes)
    node_min, node_max = _refit_rmq(tree.first, tree.last,
                                    leaf_min, leaf_max)
    skip = _skip_links_rmq(tree)
    return Bvh(spheres=sorted_spheres, order=order, left=tree.left,
               right=tree.right, node_min=node_min, node_max=node_max,
               leaf_min=leaf_min, leaf_max=leaf_max, skip=skip,
               parent=tree.parent, leaf_parent=tree.leaf_parent)
