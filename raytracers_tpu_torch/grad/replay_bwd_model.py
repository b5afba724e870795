"""K2's slot-table accumulation, modelled from the records alone.

The counterpart of the warp schedule of ``csrc/replay_bwd.cu``, as
``render/traversal_model.py`` is of K3's.  The kernel runs blocks of
``THREADS`` threads, a warp on 32 consecutive rays.  Pass 2 of a warp runs
as many iterations as its longest path has steps, every lane at the same
step k (from the warp's deepest step down to 0); a lane whose path is
shorter waits until k is within it.  In each iteration the lanes that
replayed a bounce meet by slot (``__match_any_sync``): each group of lanes
on one slot sums its 7 cotangents in registers, down the tree of
Westphal's ``reduce_peers``, and its lowest lane adds the sums into the
slot's row of the table with one float32 atomic a field: one row-add.

``warp_groups`` gives, per warp and iteration, the bounce slots of its
lanes and the number of distinct ones, hence the exact row-adds and warp
iterations the kernel's counters report (``replay_bwd.COUNTERS``) and the
conflict factor, bounces over row-adds.  ``aggregated_table`` emulates the
table in float32: each group summed in the kernel's order, then the group
sums added slot by slot in a fixed order (the kernel's atomics land in no
fixed order, so its table differs from this one in the last bits; both lie
within the bound of a float32 sum in any order).  ``align="end"`` models
the other alignment, each lane at its own k = L - 1 - i, which
``probes/k2_table.py`` measures against the kernel's.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

WARP = 32
THREADS = 128               # kThreads of csrc/replay_bwd.cu
F32_MIN_NORMAL = 2.0 ** -126
ALIGNS = ("depth", "end")


def path_lengths(rec: torch.Tensor) -> torch.Tensor:
    """Each ray's recorded steps (n,) int64, as pass 1 counts them: up to
    its first inactive step (-2), or through its first miss or absorption
    (-1, -3), or all D."""
    D, n = rec.shape
    steps = torch.arange(1, D + 1, device=rec.device)[:, None]
    # a step past which the path does not go: -2 ends before it, -1 and -3
    # after it
    end = torch.where(rec == -2, steps - 1,
                      torch.where(rec < 0, steps, D))
    return end.amin(0).long()


class WarpGroups(NamedTuple):
    """Pass 2's iterations of a launch, per warp (padded to whole blocks).

    ``slots`` (I, n_warps, 32) int64: each lane's bounce slot in iteration
    i, or -1 where it replayed no bounce (I is the longest path);
    ``groups`` (I, n_warps): distinct slots among them, the row-adds;
    ``largest`` (I, n_warps): the lanes of the largest group;
    ``iterations`` (n_warps,): the warp's iterations, its longest path."""
    slots: torch.Tensor
    groups: torch.Tensor
    largest: torch.Tensor
    iterations: torch.Tensor

    @property
    def row_adds(self) -> int:
        return int(self.groups.sum())

    @property
    def warp_iterations(self) -> int:
        return int(self.iterations.sum())

    @property
    def bounces(self) -> int:
        return int((self.slots >= 0).sum())

    @property
    def conflict(self) -> float:
        """Bounces per row-add: how many lanes one atomic row serves."""
        return self.bounces / max(self.row_adds, 1)

    @property
    def matches(self) -> int:
        """Iterations that run ``__match_any_sync``: those with a bounce."""
        return int((self.groups >= 1).sum())

    @property
    def shuffle_rounds(self) -> int:
        """Rounds of 7 shuffles: ceil(log2) of each iteration's largest
        group (5 for a whole warp's shuffle-down tree)."""
        m = self.largest.clamp(min=1).double()
        return int(torch.ceil(torch.log2(m)).sum())

    def per_bounce(self) -> dict:
        """The aggregation's warp instructions a bounce: MATCH, SHFL (7 a
        round) and the float32 atomics RED (7 a row-add)."""
        b = max(self.bounces, 1)
        return dict(match=self.matches / b, shfl=7 * self.shuffle_rounds / b,
                    red=7 * self.row_adds / b)


def _lanes(rec: torch.Tensor, align: str):
    """Per iteration, warp and lane: the step k (I, W, 32), whether it is
    within the lane's path, and the padded ray index of each lane."""
    if align not in ALIGNS:
        raise ValueError(f"align must be one of {ALIGNS}")
    D, n = rec.shape
    n_pad = -(-n // THREADS) * THREADS
    L = F.pad(path_lengths(rec), (0, n_pad - n)).view(-1, WARP)
    Lw = L.amax(1)
    n_iter = int(Lw.max()) if Lw.numel() else 0
    i = torch.arange(n_iter, device=rec.device)[:, None, None]
    if align == "depth":
        k = (Lw[None, :, None] - 1 - i).expand(-1, -1, WARP)
        active = (k >= 0) & (k < L[None])
    else:
        k = L[None] - 1 - i
        active = k >= 0
    ray = torch.arange(n_pad, device=rec.device).view(1, -1, WARP)
    return k.clamp(0, D - 1), active & (ray < n), ray.clamp(max=n - 1), Lw


def warp_groups(rec: torch.Tensor, align: str = "depth") -> WarpGroups:
    """The kernel's table groups of a launch on the records ``rec`` (D, n)
    (see the module's docstring)."""
    k, active, ray, Lw = _lanes(rec, align)
    e = rec[k, ray].long()
    slots = torch.where(active & (e >= 0), e, -1)
    s = slots.sort(-1).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[..., 1:] = s[..., 1:] != s[..., :-1]
    groups = ((s >= 0) & first).sum(-1)
    seg = first.long().cumsum(-1) - 1
    size = torch.zeros_like(seg).scatter_add_(-1, seg, (s >= 0).long())
    return WarpGroups(slots, groups, size.amax(-1), Lw)


def _ftz(x: torch.Tensor) -> torch.Tensor:
    """A float32 atomic add's flush: subnormals to a zero of their sign."""
    return torch.where(x.abs() < F32_MIN_NORMAL, x * 0.0, x)


def group_sums(slots: torch.Tensor, x: torch.Tensor):
    """Each group's sum in the kernel's order.  ``slots`` (..., 32) as in
    ``WarpGroups``, ``x`` (..., 32, 7) float32 each lane's cotangents.
    Returns (slot, sums (7,)) of every group's lowest lane, flattened in
    the order of the leading axes, then of that lane.

    The lanes of a slot, in lane order, are places 0..m-1 of its group;
    round r adds to each place that is a multiple of 2^(r+1) the sum held
    by place + 2^r, where there is one (``reduce_peers``, whose round r
    retires the places that are odd multiples of 2^r).  A whole warp on one
    slot (the kernel's ``__shfl_down_sync`` path) is the same tree."""
    lane = torch.arange(WARP, device=slots.device)
    key = torch.where(slots >= 0, slots, -1 - lane) * WARP + lane
    order = key.argsort(-1)
    ks = torch.gather(slots, -1, order)
    kk = torch.gather(key, -1, order) // WARP          # the group's key
    xs = torch.gather(x, -2, order[..., None].expand(x.shape))
    start = torch.ones_like(kk, dtype=torch.bool)
    start[..., 1:] = kk[..., 1:] != kk[..., :-1]
    seg = start.long().cumsum(-1) - 1
    first = torch.where(start, lane, 0).cummax(-1).values
    rel = lane - first
    size = torch.zeros_like(seg).scatter_add_(-1, seg, torch.ones_like(seg))
    m = torch.gather(size, -1, seg)
    for r in range(5):
        step = 1 << r
        take = (rel % (2 * step) == 0) & (rel + step < m)
        xs = torch.where(take[..., None], xs + xs.roll(-step, dims=-2), xs)
    lead = start & (ks >= 0)
    return ks[lead], xs[lead]


def aggregated_table(rec: torch.Tensor, cot_step: torch.Tensor,
                     n_slots: int, align: str = "depth") -> torch.Tensor:
    """The (n_slots, 7) float32 table the kernel's order gives, from the
    per-step cotangents ``cot_step`` (D, 8, n) of the plain version: the
    groups of ``warp_groups`` summed as ``group_sums`` does, then added into
    each slot's row in the order of iteration, warp and lane, from zero,
    each add flushed as a float32 atomic flushes."""
    k, active, ray, _ = _lanes(rec, align)
    e = rec[k, ray].long()
    slots = torch.where(active & (e >= 0), e, -1)
    x = cot_step[:, :7].float().permute(0, 2, 1)[k, ray]    # (I, W, 32, 7)
    x = torch.where((slots >= 0)[..., None], x, 0.0)
    slot, sums = group_sums(slots, x)
    table = torch.zeros(n_slots, 7, dtype=torch.float32, device=rec.device)
    if slot.numel() == 0:
        return table
    # the j-th group of each slot, for j = 0, 1, ...: one add a slot a step
    idx = torch.sort(slot, stable=True)
    s_sorted, v_sorted = idx.values, sums[idx.indices]
    start = torch.ones_like(s_sorted, dtype=torch.bool)
    start[1:] = s_sorted[1:] != s_sorted[:-1]
    pos = torch.arange(s_sorted.numel(), device=rec.device)
    j = pos - torch.where(start, pos, 0).cummax(0).values
    for step in range(int(j.max()) + 1):
        at = j == step
        rows = s_sorted[at]
        table[rows] = _ftz(table[rows] + _ftz(v_sorted[at]))
    return table
