"""rgbbox (athas/raytracers ``futhark/ray.fut:176-221``): four walls of
n x n spheres of radius k / 2n, in the order left (x = -k/2), middle
(z = -k/2), right (x = +k/2), bottom (y = -k/2), in the suite's wall
colours."""
import numpy as np

from rtbench.scenes import wall


def spheres(n: int, k: float):
    walls = [wall(0, -k / 2, n, k, (1, 2)), wall(2, -k / 2, n, k, (0, 1)),
             wall(0, +k / 2, n, k, (1, 2)), wall(1, -k / 2, n, k, (0, 2))]
    colours = [(1, 0, 0), (1, 1, 0), (0, 0, 1), (1, 1, 1)]
    centre = np.concatenate(walls)
    colour = np.concatenate([np.tile(np.float32(c), (n * n, 1))
                             for c in colours])
    radius = np.full(len(centre), np.float32(k / (n * 2.0)))
    return centre, radius, colour
