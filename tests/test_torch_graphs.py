"""The rule by which a multi-phase frame runs from CUDA graphs, and the key
its graphs are kept under (``render/megakernel.py``), on the CPU.

A frame may run from graphs only on a CUDA device, through K1's own
wrapper and without K1's counters; its key changes with every static
argument and with each layout tensor's address, shape and dtype, and not
with the camera.  The route (one frame eager, the next captured, later
ones replayed, the least recently used key dropped first) runs here with
each captured span stood in for by a graph that runs the span's launches
again at each replay: the images equal the eager frames', each in a tensor
of its own, and the counters equal the eager path's.  The card's own
graphs are tested in ``tests/test_torch_cuda.py``.
"""
from collections import OrderedDict

import pytest
import torch

from raytracers_tpu_torch import scenes as tscenes
from raytracers_tpu_torch.render import megakernel as tmk
from raytracers_tpu_torch.render.api import pallas_config, prepare_scene
from raytracers_tpu_torch.utils import trace

torch.set_num_threads(2)
SIZE = 32
DEPTH = 16
CUDA = torch.device("cuda")     # a device object; no card is touched


def _prepared(name):
    sc = tscenes.by_name(name, device="cpu")
    return prepare_scene(sc, SIZE, SIZE, with_pallas=True, with_bvh=False,
                         device="cpu")


def _jittered(cam, j):
    """``cam`` with its lower-left corner moved by ``j`` pixels each way."""
    return cam._replace(llc=cam.llc + (j / SIZE) * cam.horizontal
                        + (j / SIZE) * cam.vertical)


def _static(ps):
    """The static arguments of ``_graph_key``, in its order."""
    tile, block, schedule, prefix = pallas_config(ps.n_clusters)
    return dict(width=SIZE, height=SIZE, max_depth=DEPTH, schedule=schedule,
                sort_prefix=prefix, tile=tile, tile2=None, block=block,
                row0=0.0, total_height=None, seg_tiles=None, coherent=False,
                occl_cont=False, far_root=True, cull=None, lane_groups=None)


def _render(ps, cam, **kw):
    st = _static(ps)
    return tmk.render_pallas_twophase(
        ps, cam, SIZE, SIZE, max_depth=DEPTH, tile=st["tile"],
        block=st["block"], schedule=st["schedule"],
        sort_prefix=st["sort_prefix"], **kw)


@pytest.mark.parametrize("case,engages", [
    ("cuda", True),
    ("cpu tensor", False),
    ("custom kernel", False),
    ("with_stats", False),
    ("counting with stats", False),
    ("counting without stats", True),
])
def test_the_rule_engages_only_on_the_main_path(case, engages):
    device = torch.device("cpu") if case == "cpu tensor" else CUDA
    kernel = (tmk.megakernel_eager if case == "custom kernel"
              else tmk.megakernel)
    with_stats = case == "with_stats"
    if case.startswith("counting"):
        with trace.counting(stats=case == "counting with stats") as c:
            assert trace.counters() is c
            got = tmk._graphs_engage(device, kernel, with_stats, c)
    else:
        got = tmk._graphs_engage(device, kernel, with_stats,
                                 trace.counters())
    assert got is engages


STATIC_CHANGES = [
    ("width", 40), ("height", 40), ("max_depth", 20), ("schedule", (3, 7)),
    ("sort_prefix", None), ("tile", 1024), ("tile2", 512),
    ("block", (32, 32)), ("row0", 8.0), ("total_height", 64),
    ("seg_tiles", 2), ("coherent", True), ("occl_cont", True),
    ("far_root", False), ("cull", False), ("lane_groups", 2)]


@pytest.fixture(scope="module")
def rgbbox():
    return _prepared("rgbbox")


@pytest.mark.parametrize("name,value", STATIC_CHANGES,
                         ids=[n for n, _ in STATIC_CHANGES])
def test_the_key_changes_with_each_static_argument(rgbbox, name, value):
    ps, st = rgbbox.pallas, _static(rgbbox.pallas)
    assert st[name] != value
    assert (tmk._graph_key(ps, CUDA, *st.values())
            != tmk._graph_key(ps, CUDA, *dict(st, **{name: value}).values()))


def _changed(t, how):
    if how == "address":
        return t.clone()
    if how == "shape":
        return torch.cat([t, t[:1]])
    return t.double()


@pytest.mark.parametrize("how", ["address", "shape", "dtype"])
@pytest.mark.parametrize("field", tmk.PallasScene._fields)
def test_the_key_changes_with_each_layout_tensor(rgbbox, field, how):
    ps, st = rgbbox.pallas, _static(rgbbox.pallas)
    other = ps._replace(**{field: _changed(getattr(ps, field), how)})
    assert (tmk._graph_key(ps, CUDA, *st.values())
            != tmk._graph_key(other, CUDA, *st.values()))


def test_the_key_holds_for_a_new_camera_and_a_list(rgbbox):
    ps, st = rgbbox.pallas, _static(rgbbox.pallas)
    key = tmk._graph_key(ps, CUDA, *st.values())
    # the camera is no argument of the key: the same layout, same tensors
    assert tmk._graph_key(tmk.PallasScene(*ps), CUDA, *st.values()) == key
    listed = dict(st, schedule=list(st["schedule"]),
                  block=list(st["block"]))
    assert tmk._graph_key(ps, CUDA, *listed.values()) == key
    assert tmk._graph_key(ps, torch.device("cuda", 1), *st.values()) != key


class _Rerun:
    """A captured span stood in for on the CPU: each replay runs the span's
    launches again."""

    def __init__(self, launches):
        self.launches = launches
        self.replays = 0

    def replay(self):
        self.launches()
        self.replays += 1


@pytest.fixture
def stand_in_graphs(monkeypatch):
    """The graph route on the CPU: the rule holds on the main path there,
    and each span's capture is a ``_Rerun``; a fresh cache of keys."""
    rule = tmk._graphs_engage
    monkeypatch.setattr(tmk, "_graphs_engage",
                        lambda device, *a: rule(CUDA, *a))
    monkeypatch.setattr(tmk, "_capture", lambda launches, pool:
                        _Rerun(launches))
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(tmk, "_graphs", OrderedDict())
    return tmk


@pytest.mark.parametrize("name", ["rgbbox", "irreg"])
def test_frames_route_eager_capture_replay(name, stand_in_graphs):
    prep = _prepared(name)
    cams = [_jittered(prep.cam, j) for j in (0.0, 0.3, -0.4, 0.1)]
    want, want_counts, counts, frames = [], [], [], []
    for cam in cams:
        with trace.counting(stats=False) as c:
            want.append(_render(prep.pallas, cam,
                                kernel=tmk.megakernel_eager))
        want_counts.append(c.read())
        with trace.counting(stats=False) as c:
            frames.append(_render(prep.pallas, cam))
        counts.append(c.read())
    assert [n["render.graph"] for n in counts] == [
        {"total": 1, part: 1}
        for part in ("eager", "capture", "replay", "replay")]
    # each frame in a tensor of its own, unchanged by the frames after it
    assert len({f.data_ptr() for f in frames}) == len(frames)
    for got, ref in zip(frames, want):
        assert torch.equal(got, ref)
    assert not torch.equal(want[0], want[1])
    # the rays and the survivors a phase as the eager path counts them
    for n, ref in zip(counts, want_counts):
        for counter in ("k1.rays_launched", "k1.rays_live_in"):
            assert n[counter] == ref[counter]
    graphs = stand_in_graphs._graphs
    (entry,) = graphs.values()
    assert [g.replays for _, g in entry.graphs] == [3] * len(entry.graphs)
    schedule = _static(prep.pallas)["schedule"]
    assert [n for n, _ in entry.graphs] == (
        [s for k in range(len(schedule))
         for s in (f"rt.phase{k}", f"rt.boundary{k}")]
        + [f"rt.phase{len(schedule)}", "rt.unpermute"])


def test_counting_with_stats_and_custom_kernels_stay_eager(
        rgbbox, stand_in_graphs):
    ps, cam = rgbbox.pallas, rgbbox.cam
    for _ in range(2):
        _render(ps, cam)
    with trace.counting() as c:
        _render(ps, cam)
        _render(ps, cam, kernel=tmk.megakernel_eager)
        _render(ps, cam, with_stats=True)
    n = c.read()
    assert n["render.graph"] == {"total": 3, "eager": 3}
    assert "k1.slot_tests" in n


def test_the_least_recently_used_key_goes_first(rgbbox, stand_in_graphs):
    ps, cam = rgbbox.pallas, rgbbox.cam
    depths = [DEPTH + i for i in range(tmk.GRAPH_ENTRIES + 1)]

    def route(depth):
        with trace.counting(stats=False) as c:
            tmk.render_pallas_twophase(ps, cam, SIZE, SIZE, max_depth=depth,
                                       tile=256, schedule=(3, 4))
        (part,) = set(c.read()["render.graph"]) - {"total"}
        return part
    assert [route(d) for d in depths[:2]] == ["eager", "eager"]
    assert route(depths[0]) == "capture"
    for d in depths[2:]:
        route(d)
    # depths[1] was the least recently used of GRAPH_ENTRIES + 1 keys
    assert len(stand_in_graphs._graphs) == tmk.GRAPH_ENTRIES
    assert route(depths[0]) == "replay"
    assert route(depths[1]) == "eager"


def _route(ps, cam):
    with trace.counting(stats=False) as c:
        _render(ps, cam)
    (part,) = set(c.read()["render.graph"]) - {"total"}
    return part


def test_a_layout_at_a_freed_layouts_addresses_is_new(rgbbox,
                                                      stand_in_graphs):
    """A layout whose tensors sit where a freed layout's sat, with its
    shapes and dtypes, has the freed one's key: its first frame runs
    eagerly all the same, and only its second captures."""
    ps, cam = rgbbox.pallas, rgbbox.cam
    # the freed layout: other tensors over the same memory
    freed = tmk.PallasScene(*(t.view(t.shape) for t in ps))
    st = _static(ps)
    assert (tmk._graph_key(freed, CUDA, *st.values())
            == tmk._graph_key(ps, CUDA, *st.values()))
    assert _route(freed, cam) == "eager"
    del freed
    assert [_route(ps, cam) for _ in range(3)] == [
        "eager", "capture", "replay"]


def test_a_first_frame_keeps_no_layout_alive(stand_in_graphs):
    """The mark a key's first frame leaves holds its layout weakly: a
    layout rebuilt every frame is freed with its last reference, and every
    frame of it runs eagerly."""
    import weakref
    prep = _prepared("irreg")
    refs = []
    for j in range(3):
        ps = tmk.PallasScene(*(t.clone() for t in prep.pallas))
        refs.append(weakref.ref(ps.sphT))
        assert _route(ps, _jittered(prep.cam, 0.1 * j)) == "eager"
        del ps
    assert [r() for r in refs] == [None] * 3


def test_released_graphs_free_their_layout(stand_in_graphs):
    """``release_graphs()`` drops every kept entry and its hold on its
    layout; the key's next frame runs eagerly."""
    import weakref
    prep = _prepared("rgbbox")
    ps = tmk.PallasScene(*(t.clone() for t in prep.pallas))
    assert [_route(ps, prep.cam) for _ in range(3)] == [
        "eager", "capture", "replay"]
    ref = weakref.ref(ps.sphT)
    tmk.release_graphs()
    assert not stand_in_graphs._graphs
    assert _route(ps, prep.cam) == "eager"
    del ps
    tmk.release_graphs()
    assert ref() is None
