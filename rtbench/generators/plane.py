"""irreg (athas/raytracers ``futhark/ray.fut:223-237``): one plane of
n x n white spheres of radius k / 2n at y = 0."""
import numpy as np

from rtbench.scenes import wall


def spheres(n: int, k: float):
    centre = wall(1, 0.0, n, k, (0, 2))
    radius = np.full(len(centre), np.float32(k / (n * 2.0)))
    colour = np.ones((len(centre), 3), dtype=np.float32)
    return centre, radius, colour
