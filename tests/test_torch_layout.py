"""The port's scene layout against the JAX package's, table for table, and
the layout kernel against the plain build on the card.

``build_clusters`` and ``build_pallas_scene`` of ``raytracers_tpu_torch``
must give exactly the JAX package's tensors: the Morton sort is stable, the
front-to-back cluster order uses a stable argsort over distances summed in
JAX's order, and the padding, super-AABB and tail-peel tables follow the
same rules.  Those cases run on the CPU, where ``build_pallas_scene`` takes
the plain build.

On a CUDA tensor ``build_pallas_scene`` runs ``csrc/layout.cu`` (the
``cuda`` cases, which skip without a card): every table must equal the
plain build's, bit for bit but for a zero of ``aabbT`` or ``superT`` whose
sign alone differs.  On a machine with the card, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_layout.py -m cuda

The module imports JAX only inside the CPU cases that compare with it, since
the card's machine has none.
"""
import types

import numpy as np
import pytest
import torch

from raytracers_tpu_torch import scenes as tscenes
from raytracers_tpu_torch.bvh import lbvh as tlbvh
from raytracers_tpu_torch.geometry import Spheres
from raytracers_tpu_torch.render import megakernel as tmk
from raytracers_tpu_torch.utils.trace import counting

torch.set_num_threads(2)
CPU = "cpu"


def _jx():
    """The JAX package's scenes, LBVH and kernel layout and the port's
    converter, imported at first use."""
    from raytracers_tpu import scenes as jscenes
    from raytracers_tpu.bvh import lbvh as jlbvh
    from raytracers_tpu.render import pallas_kernel as jpk
    from raytracers_tpu_torch import convert
    return types.SimpleNamespace(scenes=jscenes, lbvh=jlbvh, pk=jpk,
                                 convert=convert)


def _eq(port, ref):
    np.testing.assert_array_equal(np.asarray(port), np.asarray(ref))


def _subset(sph, n):
    return type(sph)(sph.center[:n], sph.radius[:n], sph.color[:n])


@pytest.mark.parametrize("name,leaf", [("rgbbox", 128), ("irreg", 128),
                                       ("irreg", 8)])
def test_build_clusters_equal(name, leaf):
    j = _jx()
    jsph = j.scenes.by_name(name).spheres
    ref = j.lbvh.build_clusters(jsph, leaf_size=leaf)
    port = tlbvh.build_clusters(j.convert.spheres(jsph, CPU), leaf_size=leaf)
    for p, r in zip(port.spheres, ref.spheres):
        _eq(p, r)
    _eq(port.order, ref.order)
    _eq(port.leaf_min, ref.leaf_min)
    _eq(port.leaf_max, ref.leaf_max)
    assert port.n_leaves == ref.n_leaves


def _layout_case(case):
    """(JAX Spheres, sort_origin, cull_rows) of one layout case."""
    jscenes = _jx().scenes
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
    j = _jx()
    jsph, origin, cull_rows = _layout_case(case)
    ref = j.pk.build_pallas_scene(jsph, sort_origin=origin,
                                  cull_rows=cull_rows)
    port = tmk.build_pallas_scene(j.convert.spheres(jsph, CPU),
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
    sc = _jx().scenes.irreg()
    convert = _jx().convert
    port = tmk.build_pallas_scene(convert.spheres(sc.spheres, CPU),
                                  sort_origin=sc.look_from)
    unsorted = tmk.build_pallas_scene(convert.spheres(sc.spheres, CPU))
    box = unsorted.aabbT.reshape(-1, 8)[:79]
    ctr = 0.5 * (box[:, :3] + box[:, 3:6]) - torch.tensor(sc.look_from)
    dist = (ctr * ctr).sum(dim=1)
    assert len(torch.unique(dist)) < len(dist)
    assert not torch.equal(port.order, unsorted.order)


# ---------------------------------------------------------------------------
# the dispatch


def test_cpu_takes_the_plain_build(monkeypatch):
    """A CPU tensor takes ``_build_pallas_scene_plain``, counts no layout
    launch and never reaches the kernel's path."""
    calls = []
    plain = tmk._build_pallas_scene_plain

    def spy(*args):
        calls.append(args)
        return plain(*args)

    def kernel(*args):
        raise AssertionError("a CPU tensor reached the layout kernel")

    monkeypatch.setattr(tmk, "_build_pallas_scene_plain", spy)
    monkeypatch.setattr(tmk, "_build_pallas_scene_cuda", kernel)
    sc = tscenes.rgbbox(device=CPU)
    with counting(stats=False) as c:
        ps = tmk.build_pallas_scene(sc.spheres, sort_origin=sc.look_from,
                                    cluster_width=64)
    assert len(calls) == 1 and calls[0][1:] == (sc.look_from, None, 64)
    assert "layout.launches" not in c.read()
    ref = plain(sc.spheres, sc.look_from, None, 64)
    for field in tmk.PallasScene._fields:
        assert torch.equal(getattr(ps, field), getattr(ref, field)), field


def test_other_devices_raise():
    """Neither CPU nor CUDA: the layout raises, as the kernels do."""
    sph = Spheres(torch.zeros(300, 3, device="meta"),
                  torch.ones(300, device="meta"),
                  torch.zeros(300, 3, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        tmk.build_pallas_scene(sph)


# ---------------------------------------------------------------------------
# the layout kernel on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the layout kernel is CUDA")
    return torch.device("cuda")


def _card_case(case, device):
    """(Spheres, sort_origin, cull_rows, cluster_width) of a card case."""
    name, _, rest = case.partition("-")
    opts = set(rest.split("-")) if rest else set()
    cull_rows = 32 if "cr32" in opts else (64 if "cr64" in opts else None)
    width = 64 if "w64" in opts else (32 if "w32" in opts else None)
    if name == "random":
        sph = tscenes.random_spheres(20_000, seed=5, extent=200.0,
                                     device=device)
        origin = (0.0, 0.0, 260.0)
    else:
        sc = tscenes.by_name(name, device=device)
        sph, origin = sc.spheres, sc.look_from
    counts = [int(o) for o in opts if o.isdigit()]
    if counts:
        sph = Spheres(*(t[:counts[0]].contiguous() for t in sph))
    return sph, (origin if "sorted" in opts else None), cull_rows, width


def _assert_layouts_equal(got, want):
    """Every field equal, bit for bit; ``aabbT`` and ``superT`` may differ
    in the sign of a zero alone."""
    for field in tmk.PallasScene._fields:
        a = getattr(got, field)
        b = getattr(want, field).to(a.device)
        assert a.shape == b.shape and a.dtype == b.dtype, field
        if a.dtype == torch.float32 and field in ("aabbT", "superT"):
            assert torch.equal(a, b), field
        elif a.dtype == torch.float32:
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), \
                field
        else:
            assert torch.equal(a, b), field


@pytest.mark.cuda
@pytest.mark.parametrize("case,clusters", [
    ("rgbbox", 4), ("rgbbox-sorted", 4),
    ("irreg", 79), ("irreg-sorted", 79),
    ("rgbbox-w64", 7), ("rgbbox-w32", 13),
    ("irreg-w64", 157), ("irreg-sorted-w32", 313),
    ("irreg-37", 1), ("irreg-128", 1),         # one padded cluster
    ("irreg-512", 4), ("irreg-384-w64", 6),   # the last cluster full
    ("random-cr32", 157), ("random-sorted-cr64", 157),
    ("plane-sorted-cr32", 781), ("plane-cr64", 781),
])
def test_cuda_layout_equals_plain(cuda, case, clusters):
    """The kernel's layout on the card equals the plain build of the same
    spheres on the CPU."""
    sph, origin, cull_rows, width = _card_case(case, cuda)
    got = tmk.build_pallas_scene(sph, sort_origin=origin, cull_rows=cull_rows,
                                 cluster_width=width)
    want = tmk._build_pallas_scene_plain(
        Spheres(*(t.cpu() for t in sph)), origin, cull_rows,
        width or tmk.LANE)
    assert got.n_clusters == clusters
    assert got.sphT.device.type == "cuda"
    _assert_layouts_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case,launches", [
    ("rgbbox", {"total": 2, "codes": 1, "pack": 1}),
    ("irreg-sorted", {"total": 3, "codes": 1, "pack": 2}),
    ("irreg-37", {"total": 1, "pack": 1}),
])
def test_cuda_layout_launches(cuda, case, launches):
    """``layout.launches`` by stage: the codes for more than 128 spheres,
    the pack, and the pack again for the front-to-back order."""
    sph, origin, cull_rows, width = _card_case(case, cuda)
    with counting(stats=False) as c:
        tmk.build_pallas_scene(sph, sort_origin=origin)
    assert c.read()["layout.launches"] == launches


@pytest.mark.cuda
def test_cuda_layout_built_every_call(cuda):
    """Spheres changed in place between two calls give the new layout: the
    build keeps nothing from one call to the next."""
    sc = tscenes.irreg(device=cuda)
    sph = Spheres(*(t.clone() for t in sc.spheres))
    first = tmk.build_pallas_scene(sph)
    sph.radius.mul_(1.5)
    sph.center[:, 0].add_(3.0)
    second = tmk.build_pallas_scene(sph)
    assert not torch.equal(first.sphT, second.sphT)
    _assert_layouts_equal(second, tmk._build_pallas_scene_plain(
        Spheres(*(t.cpu() for t in sph)), None, None, tmk.LANE))


@pytest.mark.cuda
def test_cuda_layout_rejects_what_it_cannot_take(cuda):
    """A CUDA input that is not contiguous float32 raises."""
    sc = tscenes.rgbbox(device=cuda)
    wide = torch.cat([sc.spheres.center, sc.spheres.radius[:, None]], 1)
    for bad in (Spheres(sc.spheres.center.double(), *sc.spheres[1:]),
                Spheres(wide[:, :3], *sc.spheres[1:]),
                Spheres(sc.spheres.center, wide[:, 3], sc.spheres.color)):
        with pytest.raises(ValueError, match="contiguous float32"):
            tmk.build_pallas_scene(bad)
