"""Karras binary radix tree over sorted Morton codes.

Counterpart of ``raytracers_tpu.bvh.radix_tree``: the same trees, field for
field.  ``build_radix_tree`` answers every Karras search as a range-min
query over the adjacent deltas ``A[k] = delta(k, k+1)`` (sparse tables built
by static shifts, binary lifting for the range end, one packed
``(delta << 21) | index`` query for the split); ``build_radix_tree_searches``
is the per-node-search formulation of the reference
(futhark/radixtree.fut:23-64), kept as the cross-check oracle and as the
build beyond 2^21 leaves, where the packed key runs out of index bits.

torch has no ``clz`` and little uint32 arithmetic on CUDA, so the codes are
int64 tensors holding values below 2^32, and ``clz32`` counts leading zeros
with exact integer shifts.  torch indexing wraps negative indices and raises
on out-of-range ones where JAX clamps, so every gather index here is clipped
or in range by construction.  Both builds run on the device of the codes;
the RMQ build has static loop bounds and never waits on the host.

Node encoding: a child id ``c`` is inner node ``c`` when ``c < n-1`` and leaf
``c - (n-1)`` otherwise; the root is inner node 0.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

_INDEX_BITS = 21                   # index field of the packed split key
_I32_MAX = 2 ** 31 - 1


class RadixTree(NamedTuple):
    """n-leaf binary radix tree: n-1 inner nodes; each covers the
    contiguous leaf range [first, last].  All fields int32."""
    left: torch.Tensor          # (n-1,) encoded child id
    right: torch.Tensor         # (n-1,) encoded child id
    parent: torch.Tensor        # (n-1,) parent inner id; root: -1
    leaf_parent: torch.Tensor   # (n,) parent inner id
    first: torch.Tensor         # (n-1,) leaf-range start
    last: torch.Tensor          # (n-1,) leaf-range end (inclusive)

    @property
    def n_inner(self) -> int:
        return self.left.shape[0]

    @property
    def n_leaves(self) -> int:
        return self.leaf_parent.shape[0]


def clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of each value of an int64 tensor in [0, 2^32), as the
    32-bit ``clz`` counts them (32 for 0)."""
    n = torch.zeros_like(x)
    y = x
    for s in (16, 8, 4, 2, 1):
        big = y >= (1 << s)
        n = n + big * s
        y = torch.where(big, y >> s, y)
    return 32 - (n + y)


def _codes(codes) -> torch.Tensor:
    codes = torch.as_tensor(codes)
    if codes.dtype != torch.int64:
        # uint32 arrays carried over from numpy arrive as int64 values
        codes = codes.to(torch.int64) & 0xFFFFFFFF
    return codes


def _make_delta(codes: torch.Tensor):
    """delta(i, j): common-prefix length of codes i and j, with the index
    tiebreak for duplicate codes; -1 out of range
    (futhark/radixtree.fut:13-21)."""
    n = codes.shape[0]

    def delta(i, j):
        in_range = (j >= 0) & (j < n)
        js = j.clamp(0, n - 1)
        ci = codes[i]
        cj = codes[js]
        d_code = clz32(ci ^ cj)
        d_tie = 32 + clz32(i ^ js)
        return torch.where(in_range, torch.where(ci == cj, d_tie, d_code), -1)

    return delta


def _parents(left, right, n_inner: int, n: int):
    """Parent of every extended node id.  Each child id has exactly one
    parent, so the scatter writes every slot at most once."""
    idx = torch.arange(n_inner, dtype=torch.int64, device=left.device)
    all_parent = torch.full((n_inner + n,), -1, dtype=torch.int64,
                            device=left.device)
    all_parent[left] = idx
    all_parent[right] = idx
    return all_parent[:n_inner], all_parent[n_inner:]


def _tree(left, right, first, last, n_inner: int, n: int) -> RadixTree:
    parent, leaf_parent = _parents(left, right, n_inner, n)
    i32 = torch.int32
    return RadixTree(left=left.to(i32), right=right.to(i32),
                     parent=parent.to(i32), leaf_parent=leaf_parent.to(i32),
                     first=first.to(i32), last=last.to(i32))


def _children(first, last, gamma, n_inner: int):
    """Child encoding (radixtree.fut:53-62): split at gamma | gamma+1."""
    left = torch.where(first == gamma, n_inner + gamma, gamma)
    right = torch.where(last == gamma + 1, n_inner + gamma + 1, gamma + 1)
    return left, right


def build_radix_tree_searches(codes) -> RadixTree:
    """Per-node-search build (the reference's literal formulation,
    radixtree.fut:23-64): every node runs its three searches as one batch,
    each search a loop over all nodes that runs until every node is done,
    the counterpart of ``vmap`` of a ``while_loop``."""
    codes = _codes(codes)
    n = codes.shape[0]
    n_inner = n - 1
    delta = _make_delta(codes)
    i = torch.arange(n_inner, dtype=torch.int64, device=codes.device)

    # direction of the node's range (radixtree.fut:27); the deltas are
    # distinct for a (code, index)-sorted sequence, so d is +-1
    d = torch.sign(delta(i, i + 1) - delta(i, i - 1))
    delta_min = delta(i, i - d)

    # exponential upper bound for the range length (radixtree.fut:30-34)
    l_max = torch.full_like(i, 2)
    go = delta(i, i + l_max * d) > delta_min
    while bool(go.any()):
        l_max = torch.where(go, l_max * 2, l_max)
        go = go & (delta(i, i + l_max * d) > delta_min)

    # binary search for the exact range end (radixtree.fut:36-41)
    l = torch.zeros_like(i)
    t = l_max // 2
    while bool((t > 0).any()):
        better = (t > 0) & (delta(i, i + (l + t) * d) > delta_min)
        l = torch.where(better, l + t, l)
        t = t // 2
    j = i + l * d

    # binary search for the split position (radixtree.fut:44-51)
    delta_node = delta(i, j)
    s = torch.zeros_like(i)
    q = torch.ones_like(i)
    go = q <= l
    while bool(go.any()):
        t = (l + (q * 2) - 1) // (q * 2)       # ceil-div, radixtree.fut:4
        better = go & (delta(i, i + (s + t) * d) > delta_node)
        s = torch.where(better, s + t, s)
        q = torch.where(go, q * 2, q)
        go = q <= l
    gamma = i + s * d + d.clamp(max=0)

    first = torch.minimum(i, j)
    last = torch.maximum(i, j)
    left, right = _children(first, last, gamma, n_inner)
    return _tree(left, right, first, last, n_inner, n)


def adjacent_deltas(codes) -> torch.Tensor:
    """A[k] = delta(k, k+1) for sorted (n,) codes -> (n-1,) int64.

    delta(i, j) is the minimum of A over [i, j); adjacent values are always
    distinct, and the minimum over any node range is unique."""
    codes = _codes(codes)
    n = codes.shape[0]
    ci, cj = codes[:-1], codes[1:]
    idx = torch.arange(n - 1, dtype=torch.int64, device=codes.device)
    d_code = clz32(ci ^ cj)
    d_tie = 32 + clz32(idx ^ (idx + 1))
    return torch.where(ci == cj, d_tie, d_code)


def _sparse_min_table(A: torch.Tensor, kmax: int, pad: int) -> torch.Tensor:
    """ST[k][p] = min(A[p : p+2^k]) with out-of-range slots = ``pad``
    -> (kmax+1, m).  Static shifts only."""
    m = A.shape[0]
    rows = [A]
    cur = A
    for k in range(1, kmax + 1):
        h = 1 << (k - 1)
        if h < m:
            shifted = torch.cat([cur[h:], A.new_full((h,), pad)])
        else:
            shifted = A.new_full((m,), pad)
        cur = torch.minimum(cur, shifted)
        rows.append(cur)
    return torch.stack(rows)


def floor_log2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) of positive int64 values below 2^32, exactly."""
    return 31 - clz32(x)


def build_radix_tree(codes) -> RadixTree:
    """Sorted (n,) codes -> RadixTree, n >= 2.  The RMQ formulation: the
    same tree as ``build_radix_tree_searches``, with ~log n gathers in all
    instead of ~3 log n search steps per node."""
    codes = _codes(codes)
    n = codes.shape[0]
    if n >= (1 << _INDEX_BITS):
        # the packed (delta << 21 | idx) key holds 21 index bits
        return build_radix_tree_searches(codes)
    n_inner = n - 1
    m = n_inner                       # adjacent-delta count
    kmax = max(1, int(m - 1).bit_length())
    dev = codes.device

    A = adjacent_deltas(codes)                       # (m,)
    # window mins; pad -2 so any window crossing the end fails even for
    # the root's delta_min = -1
    ST = _sparse_min_table(A, kmax, -2)
    # packed (delta << 21 | position) for the one-query split argmin
    P = _sparse_min_table(
        (A << _INDEX_BITS) | torch.arange(m, dtype=torch.int64, device=dev),
        kmax, _I32_MAX)

    i = torch.arange(n_inner, dtype=torch.int64, device=dev)
    a_prev = torch.cat([A.new_full((1,), -1), A[:-1]])
    # direction and boundary delta (radixtree.fut:27)
    d = torch.where(A > a_prev, 1, -1)
    delta_min = torch.where(d > 0, a_prev, A)

    # range end by binary lifting: extend [i, pos) (d=+1) or [pos, i)
    # (d=-1) by the largest power-of-two window whose min still beats
    # delta_min (radixtree.fut:30-41)
    pos = i
    for k in range(kmax, -1, -1):
        step = 1 << k
        q_idx = torch.where(d > 0, pos, pos - step)
        valid = (q_idx >= 0) & (q_idx < m)
        qv = ST[k][q_idx.clamp(0, m - 1)]
        ok = valid & (qv > delta_min)
        pos = torch.where(ok, pos + d * step, pos)
    first = torch.where(d > 0, i, pos)
    last = torch.where(d > 0, pos, i)

    # split = the unique argmin of A over [first, last) in one overlapping
    # two-window query (radixtree.fut:44-51)
    kq = floor_log2(last - first)                    # length >= 1
    Pf = P.reshape(-1)
    q1 = Pf[kq * m + first]
    q2 = Pf[kq * m + (last - (torch.ones_like(kq) << kq))]
    gamma = torch.minimum(q1, q2) & ((1 << _INDEX_BITS) - 1)

    left, right = _children(first, last, gamma, n_inner)
    return _tree(left, right, first, last, n_inner, n)


def node_depths(tree: RadixTree):
    """Depth of every inner node (root 0) by pointer doubling, 32 sweeps;
    returns (depths (n-1,) int32, max depth as a 0-d int32 tensor)."""
    parent = tree.parent.long()
    depth = (parent >= 0).long()
    jump = torch.where(parent >= 0, parent, 0)
    for _ in range(32):
        depth = depth + depth[jump]
        jump = jump[jump]
    depth = depth.to(torch.int32)
    return depth, depth.max()
