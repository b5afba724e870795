"""The work every implementation of a frame or a step has to do, and the
card's peaks: the yardstick of the ``*_roofline`` metrics.

The work is counted from the plain reference's paths on the cell's own
inputs, never from the program's counters, so it reads the same whatever
implements the kernel.  Left out on purpose: the closest-hit search (how
many spheres a ray tests depends on the acceleration structure, so it is
not work every implementation must do).  So the shares read low.

Operations are float32 lane operations (a fused multiply-add counts once),
counted in the suite's scalar code (athas/raytracers ``futhark/ray.fut``):

* a primary ray (ray.fut:109-114, 150-168): u = i / w and v = (h - j) / h
  (2 conversions, 1 subtraction, 2 divisions), d = llc + u hor + v ver -
  origin (5 a component, 15); packing its pixel (3 multiplies, 3
  conversions, 2 shifts, 2 ors, 10): 28 plain, 2 divisions;
* a segment that hits (ray.fut:32-51, 40-45, 116-124): the winner's test
  (oc 3, a 5, b 5, c 7, disc 3, its sign 1, the near root 2 and a
  division, the interval 3, the select 1: 30, a square root, a division),
  the hit point 6, the normal (3 subtractions, 3 multiplies by one
  reciprocal: 6 and a division), the normalised direction (8, a square
  root, a division), the reflection 12, the scatter test 6, the light 3:
  71 plain, 2 square roots, 3 divisions;
* a segment that misses (ray.fut:141-148): the normalised direction (8, a
  square root, a division), the sky's blend 9, times the light 3: 20
  plain, a square root, a division.

K2 replays each segment backwards.  Its count is the segment's forward
operations again plus their adjoint: one operation for each plain one,
and for a square root one division and one multiply more, for a division
one division and two multiplies more; a segment that hits adds its 7
gradient rows into the sphere's.

Square roots and divisions are charged at the weights the card measured
for them against an uncontracted multiply-add (``SQRT_OPS``, ``DIV_OPS``:
the port's probe M1 on an NVIDIA H100 80GB HBM3 at 700 W, frozen here).

Bytes: each input read once and each output written once.  A frame reads
the spheres (7 floats each) and writes the packed image (4 bytes a
pixel); K2 reads the image's cotangent (12 bytes a pixel) and each
segment's winner (4 bytes), and writes the spheres' gradients (7 floats
each).

The peaks are NVIDIA's published H100 SXM figures at a 700 W power limit:
67 TFLOP/s float32 outside the tensor cores, i.e. 33.5e12 lane operations
a second, and 3.35 TB/s of HBM.  The run reports the card's power limit
beside them.
"""
from __future__ import annotations

FP32_LANE_OPS_PER_S = 67e12 / 2
HBM_BYTES_PER_S = 3.35e12
SQRT_OPS = 8.78
DIV_OPS = 8.71


def ops(plain: float, sqrt: float = 0, div: float = 0) -> float:
    return plain + sqrt * SQRT_OPS + div * DIV_OPS


PRIMARY = ops(28, div=2)
HIT = ops(71, sqrt=2, div=3)
MISS = ops(20, sqrt=1, div=1)
K2_HIT = ops(2 * 71 + 2 * 1 + 3 * 2 + 7, sqrt=2, div=3 + 2 + 3)
K2_MISS = ops(2 * 20 + 1 + 2, sqrt=1, div=1 + 1 + 1)
SPHERE_BYTES = 7 * 4


def bound_s(n_ops: float, n_bytes: float) -> float:
    """The least time of the work: operations over the FP32 rate or bytes
    over HBM, whichever is larger."""
    return max(n_ops / FP32_LANE_OPS_PER_S, n_bytes / HBM_BYTES_PER_S)


def k1_bound_s(work: dict) -> float:
    """One frame's K1 work: its primary rays and the reference's segments,
    hits and misses; the spheres read, the image written."""
    n_ops = (work["pixels"] * PRIMARY + work["hits"] * HIT
             + work["misses"] * MISS)
    n_bytes = work["spheres"] * SPHERE_BYTES + 4 * work["pixels"]
    return bound_s(n_ops, n_bytes)


def k2_bound_s(work: dict) -> float:
    """One step's K2 work: the backward of each of the reference's
    segments; the cotangent and the winners read, the gradients written."""
    n_ops = work["hits"] * K2_HIT + work["misses"] * K2_MISS
    n_bytes = (12 * work["pixels"] + 4 * (work["hits"] + work["misses"])
               + work["spheres"] * SPHERE_BYTES)
    return bound_s(n_ops, n_bytes)
