"""``frame``: progressive anti-aliased frames of one view, one client, a
closed loop (a frame ends when the host has synchronised with the card,
and only then is the next submitted).

Set-up draws the spheres' colours (``colour_range``) and a table of
``jitters`` sub-pixel offsets of the camera's lower-left corner (up to
``jitter_px`` pixels each way; the origin stays, so the layout's
front-to-back order stays valid), then prepares the scene once
(``prepare_scene(with_pallas=True, with_bvh=False)``).  Frame i renders
with jitter i mod ``jitters`` through ``render(mode="pallas")``.
"""
from __future__ import annotations

import torch

from rtbench import check, reference, scenes


class Driver:
    def __init__(self, config: dict, mix: dict, seed: int, device):
        from raytracers_tpu_torch.geometry import Camera, Spheres
        from raytracers_tpu_torch.render.api import prepare_scene
        from raytracers_tpu_torch.scenes import Scene
        self.config, self.mix, self.device = config, mix, device
        self.W, self.H, self.D = (config["width"], config["height"],
                                  config["max_depth"])
        g = scenes.generator(seed, device)
        centre, radius, colour = scenes.spheres(config, device)
        colour = scenes.uniform(g, colour.shape, *mix["colour_range"],
                                device)
        self.spheres = (centre, radius, colour)
        origin, llc, hor, ver = scenes.camera(config, device)
        a = mix["jitter_px"]
        jit = scenes.uniform(g, (mix["jitters"], 2), -a, a, device)
        self.cams = [(origin, llc + (j[0] / self.W) * hor
                      + (j[1] / self.H) * ver, hor, ver) for j in jit]
        scene = Scene(tuple(config["look_from"]), tuple(config["look_at"]),
                      config["fov"], Spheres(*self.spheres))
        prepared = prepare_scene(scene, self.H, self.W, with_pallas=True,
                                 with_bvh=False, device=device)
        self.prepared = [prepared._replace(cam=Camera(*c))
                         for c in self.cams]

    def run(self, i: int):
        from raytracers_tpu_torch.render.api import render
        return render(self.prepared[i % len(self.prepared)], self.H, self.W,
                      mode="pallas", max_depth=self.D)

    def wait(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def inputs(self, i: int):
        return self.spheres, self.cams[i % len(self.cams)]

    def release(self):
        """Drop the program's state (the prepared layouts)."""
        self.prepared = None

    def reference(self, i: int, dtype=torch.float32):
        """The reference's packed image of frame i, and its trace's info."""
        spheres, cam = self.inputs(i)
        ref, info = reference.trace(spheres, cam, self.W, self.H, self.D,
                                    dtype=dtype)
        return reference.pack(ref), info

    @staticmethod
    def compare(out, ref, info) -> dict:
        return check.image(out, ref, info["bounces"])
