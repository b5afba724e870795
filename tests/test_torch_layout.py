"""The port's scene layout against the JAX package's, table for table.

``build_clusters`` and ``build_pallas_scene`` of ``raytracers_tpu_torch``
must give exactly the JAX package's tensors: the Morton sort is stable, the
front-to-back cluster order uses a stable argsort over distances summed in
JAX's order, and the padding, super-AABB and tail-peel tables follow the
same rules.
"""
import numpy as np
import pytest
import torch

from raytracers_tpu import scenes as jscenes
from raytracers_tpu.bvh import lbvh as jlbvh
from raytracers_tpu.geometry import Spheres as JSpheres
from raytracers_tpu.render import pallas_kernel as jpk
from raytracers_tpu_torch import convert
from raytracers_tpu_torch.bvh import lbvh as tlbvh
from raytracers_tpu_torch.render import megakernel as tmk

torch.set_num_threads(2)
CPU = "cpu"


def _eq(port, ref):
    np.testing.assert_array_equal(np.asarray(port), np.asarray(ref))


def _subset(sph, n):
    return JSpheres(sph.center[:n], sph.radius[:n], sph.color[:n])


@pytest.mark.parametrize("name,leaf", [("rgbbox", 128), ("irreg", 128),
                                       ("irreg", 8)])
def test_build_clusters_equal(name, leaf):
    jsph = jscenes.by_name(name).spheres
    ref = jlbvh.build_clusters(jsph, leaf_size=leaf)
    port = tlbvh.build_clusters(convert.spheres(jsph, CPU), leaf_size=leaf)
    for p, r in zip(port.spheres, ref.spheres):
        _eq(p, r)
    _eq(port.order, ref.order)
    _eq(port.leaf_min, ref.leaf_min)
    _eq(port.leaf_max, ref.leaf_max)
    assert port.n_leaves == ref.n_leaves


def _layout_case(case):
    """(JAX Spheres, sort_origin, cull_rows) of one layout case."""
    if case.startswith("random-20k"):
        # 157 clusters: a scene-scale layout (three cull blocks of 64, or
        # five of 32)
        sph = jscenes.random_spheres(20_000, seed=5, extent=200.0)
        return (sph, (0.0, 0.0, 260.0) if "sorted" in case else None,
                32 if "cr32" in case else None)
    if case == "plane-130-sorted":
        # 133 clusters in 3 blocks: the full blocks reorder front to back
        sc = jscenes.plane(n_side=130)
        return sc.spheres, sc.look_from, None
    name, _, rest = case.partition("-")
    sc = jscenes.by_name(name)
    if rest.isdigit():
        return _subset(sc.spheres, int(rest)), None, None
    return sc.spheres, (sc.look_from if rest == "sorted" else None), None


@pytest.mark.parametrize("case,clusters,tail", [
    ("rgbbox", 4, 16),
    ("rgbbox-sorted", 4, 16),          # C <= 16: the sort is not applied
    ("irreg-sorted", 79, 128),         # front-to-back: the peel is off
    ("irreg", 79, 16),
    ("irreg-37", 1, 64),               # ragged counts of test_pallas.py
    ("irreg-300", 3, 64),
    ("irreg-385", 4, 8),
    ("random-20k", 157, 32),
    ("random-20k-sorted", 157, 128),   # blocks reordered (n_full = 2)
    ("random-20k-sorted-cr32", 157, 128),    # CR = 32: n_full = 4
    ("plane-130-sorted", 133, 128),
])
def test_pallas_scene_equal(case, clusters, tail):
    jsph, origin, cull_rows = _layout_case(case)
    ref = jpk.build_pallas_scene(jsph, sort_origin=origin,
                                 cull_rows=cull_rows)
    port = tmk.build_pallas_scene(convert.spheres(jsph, CPU),
                                  sort_origin=origin, cull_rows=cull_rows)
    assert port.n_clusters == clusters
    assert port.tailT.shape[0] == tail
    for field in tmk.PallasScene._fields:
        p, r = getattr(port, field), getattr(ref, field)
        assert p.dtype == torch.from_numpy(np.array(r)).dtype, field
        _eq(p, r)


def test_irreg_front_to_back_order_has_ties():
    """irreg's grid is symmetric about its camera: cluster distances tie,
    so only a stable argsort reproduces the JAX order."""
    sc = jscenes.irreg()
    port = tmk.build_pallas_scene(convert.spheres(sc.spheres, CPU),
                                  sort_origin=sc.look_from)
    unsorted = tmk.build_pallas_scene(convert.spheres(sc.spheres, CPU))
    box = unsorted.aabbT.reshape(-1, 8)[:79]
    ctr = 0.5 * (box[:, :3] + box[:, 3:6]) - torch.tensor(sc.look_from)
    dist = (ctr * ctr).sum(dim=1)
    assert len(torch.unique(dist)) < len(dist)
    assert not torch.equal(port.order, unsorted.order)
