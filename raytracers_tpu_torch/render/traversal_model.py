"""Models of K3's warp schedule (``csrc/traversal.cu``), in plain Python.

The kernel's lanes each carry a ray, and a warp picks each iteration one
kind of work for all its lanes (an inner-node step, a leaf round, or the
shading of the rays whose walks have ended).  Which one, and how a leaf
round is split over the lanes, changes the time and not the result.  This
module states those rules once, as the kernel applies them, and models
what they cost:

* ``segment_width``, ``split_groups`` and ``leaf_round_split``: the split
  leaf round's shape and the rule that picks it over the serial round;
* ``split_leaf_round``: the split round's arithmetic as the lanes run it
  (lane r of a segment tests slots r, r + S, ... and keeps its first
  smallest t, then the segment's minimum of (t bits, slot));
* ``ray_sequences`` and ``schedule_share``: each ray's walk steps and
  shadings, from ``traversal_kernel_reference``'s trace, and the share of
  the lane-operations a warp schedule issues that do a ray's own work;
* ``thread_warp_share``: the same share for the thread-per-ray schedule's
  bound, from the plain version's per-ray counters alone.

The costs are lane-operations as ``csrc/traversal.cu``'s header counts
them (a slab test 39, a slot 21, a hit bounce's shading 73 and 2 roots and
6 divisions at about 8.8 each); roots of slots, far roots, latency and
memory are left out, so a share says what a schedule can remove, not the
time it reaches.
"""
from __future__ import annotations

import heapq

import numpy as np
import torch

from .traversal import _BIG, STEP_INNER, STEP_LEAF, _slot_t

WARP = 32
STEP_SHADE = 3                 # a ray's shading, after each walk
OPS_INNER, OPS_SLOT, OPS_SHADE = 39, 21, 143
# the kernel's constants (csrc/traversal.cu, measured there): a leaf round
# when at least LEAF_EIGHTHS / 8 of the walking lanes wait at leaves, a
# shading when at least SHADE_EIGHTHS / 8 of the lanes with rays wait to
# shade, and a split group charged SPLIT_OVERHEAD slot passes beyond its own
LEAF_EIGHTHS, SHADE_EIGHTHS, SPLIT_OVERHEAD = 6, 2, 8


def segment_width(K: int) -> int:
    """Lanes that share one leaf in a split round: the power of two at or
    above K, at most a warp; a warp tests 32 // S leaves at once."""
    return min(WARP, 1 << max(K - 1, 0).bit_length())


def split_groups(n_pending: int, K: int) -> int:
    """Slot passes of a split round over ``n_pending`` leaves, the
    broadcasts and minimums counted as ``SPLIT_OVERHEAD`` passes a group."""
    S = segment_width(K)
    return -(-n_pending // (WARP // S)) * (-(-K // S) + SPLIT_OVERHEAD)


def leaf_round_split(n_pending: int, K: int) -> bool:
    """The kernel's rule: split where that takes fewer slot passes than the
    serial round's K (each lane its own leaf's K slots in order)."""
    return split_groups(n_pending, K) < K


def split_leaf_round(spheres, c, best_t, o, d, a, inv_a, far_root: bool):
    """Each ray's leaf c tested as a split round tests it -> (winner's t,
    its slot): the segment's lane r keeps the first smallest root of its
    slots r, r + S, ... in (eps, best_t at entry), then the segment takes
    the smallest t's bits (t is positive and finite, or BIG, so its bits
    order as the floats do) and the smallest slot among the lanes that hold
    it.  Equal to ``_leaf_round``'s (k_t, k_best)."""
    r = _slot_t(spheres, c, best_t, o, d, a, inv_a, far_root)[0]
    m, K = r.shape
    S = segment_width(K)
    passes = -(-K // S)
    pad = torch.full((m, passes * S - K), _BIG, dtype=r.dtype,
                     device=r.device)
    lanes = torch.cat([r, pad], dim=1).view(m, passes, S)   # pass p, lane q
    lane_t, lane_p = torch.min(lanes, dim=1)                # first smallest
    lane_slot = lane_p * S + torch.arange(S, device=r.device)
    bits = lane_t.view(torch.int32)
    t_bits = bits.min(dim=1).values
    slot = torch.where(bits == t_bits[:, None], lane_slot,
                       torch.iinfo(torch.int64).max).min(dim=1).values
    return t_bits.view(torch.float32), slot


def ray_sequences(trace: list, n_rays: int) -> list:
    """Each ray's work in order, from ``traversal_kernel_reference``'s
    trace: its walk steps (``STEP_INNER``, ``STEP_LEAF``) and a
    ``STEP_SHADE`` after each walk, as int8 arrays."""
    parts = [[] for _ in range(n_rays)]
    shade = np.array([STEP_SHADE], dtype=np.int8)
    for live, kinds in trace:
        kinds = kinds.cpu().numpy().T                       # (m, steps)
        for g, row in zip(live.tolist(), kinds):
            parts[g] += [row[row > 0], shade]
    return [np.concatenate(p) if p else np.zeros(0, np.int8) for p in parts]


def _work(kind: int, K: int) -> int:
    return {STEP_INNER: OPS_INNER, STEP_LEAF: K * OPS_SLOT,
            STEP_SHADE: OPS_SHADE}[kind]


def _pick(kinds: list, policy: str):
    """The kind of work a warp runs next, given its lanes' next kinds
    (``None`` for a lane without work): ``"diverge"`` every kind some lane
    needs (the thread-per-ray kernel, each lane on its own ray);
    ``"ballot"`` the kernel's policy: shade when ``SHADE_EIGHTHS`` / 8 of
    the lanes with rays wait to shade or none walks, else a leaf round when
    ``LEAF_EIGHTHS`` / 8 of the walking lanes wait at leaves or none is at
    an inner node (the TPU kernel's rule, pallas_traversal.py:268-274, at
    its own threshold), else a tree step."""
    n = {k: kinds.count(k) for k in (STEP_INNER, STEP_LEAF, STEP_SHADE)}
    if policy == "diverge":
        return [k for k in n if n[k]]
    walking = n[STEP_INNER] + n[STEP_LEAF]
    if n[STEP_SHADE] and (8 * n[STEP_SHADE] >= SHADE_EIGHTHS
                          * (walking + n[STEP_SHADE]) or not walking):
        return [STEP_SHADE]
    if n[STEP_LEAF] and (8 * n[STEP_LEAF] >= LEAF_EIGHTHS * walking
                         or not n[STEP_INNER]):
        return [STEP_LEAF]
    return [STEP_INNER]


def schedule_share(seqs: list, K: int, *, policy: str = "ballot",
                   split: bool = True, persistent: bool = True,
                   n_warps: int | None = None) -> dict:
    """Lane-operations of the rays' own work over those a warp schedule
    issues (32 for each operation a warp runs).  Without ``persistent``
    each warp runs 32 consecutive rays to their ends; with it, ``n_warps``
    warps (default: as many as the rays fill) take runs of 32 rays from
    one counter in the order their issued work frees them, and a lane
    whose ray ends takes the warp's next.  ``split`` tests a leaf round's
    leaves split over the lanes where ``leaf_round_split`` says so.
    Returns the share, the rounds of each kind, and ``tail``: the busiest
    warp's operations over the mean warp's (the launch lasts as long as
    its busiest warp)."""
    n_rays = len(seqs)
    useful = sum(_work(int(k), K) for s in seqs for k in s)
    rounds = dict(tree=0, leaf_serial=0, leaf_split=0, shade=0)
    issued = 0
    if n_warps is None:
        n_warps = -(-n_rays // WARP)
    queue = [0]                              # the next ray of the counter

    def take(run):
        """A warp's next run of rays, as the kernel's counter gives it."""
        g0 = queue[0]
        queue[0] = min(g0 + WARP, n_rays)
        run.extend(range(g0, queue[0]))

    # per warp: its lanes' rays and positions, and its run of rays to take
    warps = []
    for w in range(n_warps):
        rays = [] if persistent else list(
            range(w * WARP, min((w + 1) * WARP, n_rays)))
        warps.append(dict(lanes=rays + [None] * (WARP - len(rays)),
                          pos=[0] * WARP, run=[]))
    heap = [(0, w) for w in range(n_warps)]
    done = [0] * n_warps                     # each warp's issued operations
    while heap:
        clock, w = heapq.heappop(heap)
        done[w] = clock
        wp = warps[w]
        lanes, pos = wp["lanes"], wp["pos"]
        if persistent:
            for q in range(WARP):
                while lanes[q] is None:
                    if not wp["run"]:
                        take(wp["run"])
                        if not wp["run"]:
                            break
                    g = wp["run"].pop(0)
                    if len(seqs[g]):
                        lanes[q], pos[q] = g, 0
        kinds = [None if g is None else int(seqs[g][pos[q]])
                 for q, g in enumerate(lanes)]
        if all(k is None for k in kinds):
            continue
        cost = 0
        for kind in _pick(kinds, policy):
            owners = [q for q, k in enumerate(kinds) if k == kind]
            if kind == STEP_LEAF and split and policy != "diverge" \
                    and leaf_round_split(len(owners), K):
                cost += split_groups(len(owners), K) * OPS_SLOT
                rounds["leaf_split"] += 1
            else:
                cost += _work(kind, K)
                rounds[{STEP_INNER: "tree", STEP_LEAF: "leaf_serial",
                        STEP_SHADE: "shade"}[kind]] += 1
            for q in owners:
                pos[q] += 1
                if pos[q] == len(seqs[lanes[q]]):
                    lanes[q] = None
        issued += WARP * cost
        heapq.heappush(heap, (clock + cost, w))
    return dict(share=useful / max(issued, 1), useful=useful, issued=issued,
                tail=max(done) * n_warps / max(sum(done), 1), **rounds)


def thread_warp_share(work: torch.Tensor) -> float:
    """The thread-per-ray schedule's bound: Σ work over Σ over warps of 32
    consecutive rays of 32 × the busiest lane's, for per-ray work (n,)
    (no schedule of a warp's 32 rays on their own lanes does better)."""
    w = work.double()
    pad = (-w.numel()) % WARP
    w = torch.cat([w, w.new_zeros(pad)]).view(-1, WARP)
    return float(w.sum() / (WARP * w.amax(dim=1)).sum().clamp_min(1.0))
