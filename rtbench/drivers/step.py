"""``step``: forward+backward steps of inverse rendering, one client, a
closed loop (a step ends when the host has synchronised with the card,
and only then is the next submitted).

Set-up draws a table of ``variants`` current estimates (each sphere's
colour moved by up to ``colour_offset`` a channel, clamped to [0, 1], and
its radius scaled by up to ``radius_offset`` either way) and the target
image (``target_range``), and builds the engine
(``make_render_pallas_diff`` with ``pallas_diff_config``).  Step i takes
fresh leaves of variant i mod ``variants`` (centres, radii, colours and
the camera's four vectors), computes ((f(spheres, cam) - target) ** 2)
.sum() and calls backward().
"""
from __future__ import annotations

import torch

from rtbench import check, reference, scenes


class Driver:
    def __init__(self, config: dict, mix: dict, seed: int, device):
        from raytracers_tpu_torch.geometry import Spheres
        from raytracers_tpu_torch.grad.pallas_diff import (
            make_render_pallas_diff)
        from raytracers_tpu_torch.render.api import pallas_diff_config
        from raytracers_tpu_torch.render.megakernel import build_pallas_scene
        self.config, self.mix, self.device = config, mix, device
        self.W, self.H, self.D = (config["width"], config["height"],
                                  config["max_depth"])
        g = scenes.generator(seed, device)
        centre, radius, colour = scenes.spheres(config, device)
        self.variants = []
        for _ in range(mix["variants"]):
            b = mix["colour_offset"]
            col = (colour + scenes.uniform(g, colour.shape, -b, b, device)
                   ).clamp(0.0, 1.0)
            s = mix["radius_offset"]
            rad = radius * scenes.uniform(g, radius.shape, 1 - s, 1 + s,
                                          device)
            self.variants.append((centre, rad, col))
        self.target = scenes.uniform(g, (self.H, self.W, 3),
                                     *mix["target_range"], device)
        self.cam = scenes.camera(config, device)
        n_clusters = build_pallas_scene(
            Spheres(*self.variants[0])).n_clusters
        tile, block, schedule, prefix = pallas_diff_config(n_clusters)
        self.engine = dict(tile=tile, block=block, schedule=schedule,
                           sort_prefix=prefix)
        self.f = make_render_pallas_diff(self.W, self.H, max_depth=self.D,
                                         **self.engine)

    def run(self, i: int):
        from raytracers_tpu_torch.geometry import Camera, Spheres
        sph = Spheres(*(t.detach().requires_grad_(True)
                        for t in self.variants[i % len(self.variants)]))
        cam = Camera(*(t.detach().requires_grad_(True) for t in self.cam))
        img = self.f(sph, cam)
        loss = ((img - self.target) ** 2).sum()
        loss.backward()
        return img.detach(), [t.grad for t in (*sph, *cam)]

    def wait(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def inputs(self, i: int):
        return self.variants[i % len(self.variants)], self.cam

    def release(self):
        """Drop the program's state (the engine)."""
        self.f = None

    def reference(self, i: int, dtype=torch.float32):
        """The reference's colours and gradients of step i (its loss's
        cotangent from its own colours), and its trace's info."""
        spheres, cam = self.inputs(i)
        ref, info = reference.trace(spheres, cam, self.W, self.H, self.D,
                                    dtype=dtype, record=True)
        cot = 2.0 * (ref - self.target.to(dtype))
        grads = reference.replay(spheres, cam, self.W, self.H,
                                 info.pop("path"), cot, dtype=dtype)
        return (ref, grads), info

    @staticmethod
    def compare(out, ref, info) -> dict:
        (img, grads), (ref_img, ref_grads) = out, ref
        numbers = check.image(reference.pack(img), reference.pack(ref_img),
                              info["bounces"])
        numbers.update(check.gradients(grads, ref_grads))
        return numbers
