"""Runtime validation of the LBVH and the scene, on the host with numpy.

Counterpart of ``raytracers_tpu.utils.validate``: each function returns the
list of violated invariants (empty when valid), for tests, debugging and
the CLI's ``--validate``, not hot paths.
"""
from __future__ import annotations

import numpy as np
import torch

from ..bvh.lbvh import Bvh
from ..geometry import Spheres


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def validate_bvh(bvh: Bvh, atol: float = 1e-5) -> list[str]:
    problems: list[str] = []
    C = bvh.n_leaves
    n_inner = bvh.n_inner
    left = _np(bvh.left)
    right = _np(bvh.right)
    parent = _np(bvh.parent)
    leaf_parent = _np(bvh.leaf_parent)
    skip = _np(bvh.skip)

    # child id ranges
    if not ((left >= 0) & (left < n_inner + C)).all():
        problems.append("left child ids out of range")
    if not ((right >= 0) & (right < n_inner + C)).all():
        problems.append("right child ids out of range")

    # parent consistency
    for cname, child in (("left", left), ("right", right)):
        for i in range(n_inner):
            c = child[i]
            p = parent[c] if c < n_inner else leaf_parent[c - n_inner]
            if p != i:
                problems.append(
                    f"parent mismatch: {cname} child {c} of inner {i} "
                    f"has parent {p}")
                break

    # every node visited exactly once by the skip threading
    cur, seen = 0, []
    limit = 4 * (n_inner + C) + 8
    while cur != -1 and len(seen) <= limit:
        seen.append(cur)
        cur = left[cur] if cur < n_inner else skip[cur]
    if sorted(seen) != list(range(n_inner + C)):
        problems.append("skip links do not thread all nodes exactly once")

    # AABB containment: sphere boxes in their leaf boxes, children in parents
    center = _np(bvh.spheres.center)
    radius = _np(bvh.spheres.radius)[:, None]
    K = bvh.leaf_size
    smin = (center - radius).reshape(C, K, 3).min(axis=1)
    smax = (center + radius).reshape(C, K, 3).max(axis=1)
    lmin = _np(bvh.leaf_min)
    lmax = _np(bvh.leaf_max)
    if (smin < lmin - atol).any() or (smax > lmax + atol).any():
        problems.append("sphere AABBs escape their leaf cluster AABBs")
    nmin = _np(bvh.node_min)
    nmax = _np(bvh.node_max)
    ext_min = np.concatenate([nmin, lmin])
    ext_max = np.concatenate([nmax, lmax])
    if ((ext_min[left] < nmin - atol).any()
            or (ext_max[left] > nmax + atol).any()
            or (ext_min[right] < nmin - atol).any()
            or (ext_max[right] > nmax + atol).any()):
        problems.append("child AABBs escape their parent AABBs")

    # order is a permutation (+ -1 padding)
    order = _np(bvh.order)
    real = np.sort(order[order >= 0])
    if not (real == np.arange(real.size)).all():
        problems.append("order is not a permutation of input indices")
    if (order < 0).any():
        if (_np(bvh.spheres.radius)[order < 0] != 0).any():
            problems.append("padding spheres must have radius 0")
    return problems


def validate_spheres(spheres: Spheres) -> list[str]:
    problems = []
    c = _np(spheres.center)
    r = _np(spheres.radius)
    col = _np(spheres.color)
    if not np.isfinite(c).all():
        problems.append("non-finite sphere centers")
    if (r < 0).any() or not np.isfinite(r).all():
        problems.append("negative or non-finite radii")
    if not np.isfinite(col).all():
        problems.append("non-finite colors")
    if c.shape[0] != r.shape[0] or c.shape[0] != col.shape[0]:
        problems.append("mismatched SoA field lengths")
    return problems
