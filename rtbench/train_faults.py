"""Faults planted under the ``train`` driver's timed path, for its tests
and probes: each wraps the driver's ``run`` (``rtbench.run.run``'s
``wrap``) and has to come out not correct under
``limits/rgbbox.train.json``.  ``calibrate.FAULTS`` key on the other
drivers' fields and do not run on this one.
"""
from __future__ import annotations

import torch

from rtbench.drivers import train


def _rebuilt(driver, mesh=None, max_depth=None, trainable=True):
    """The driver's train step built again through the port's API, on
    ``mesh``, at ``max_depth`` (its schedule cut to end before it), and
    without the masks where ``trainable`` is False."""
    from raytracers_tpu_torch.geometry import Spheres
    from raytracers_tpu_torch.grad.inverse import make_train_step_pallas
    depth = max_depth or driver.D
    return make_train_step_pallas(
        mesh or driver.mesh, driver.W, driver.H, max_depth=depth,
        trainable=Spheres(*driver.masks) if trainable else None,
        **train._engine(driver.n_clusters, depth))


def half(fn):
    """The loss and the gradients over the image's upper half alone: a
    mesh that counts two ranks where one reports."""
    from raytracers_tpu_torch.parallel.mesh import RayMesh
    driver = fn.__self__
    m = driver.mesh
    driver.step = _rebuilt(driver, RayMesh(0, 2, m.group, m.device))
    return fn


def skipped(fn):
    """The loss and the gradients computed, the update never applied."""
    driver = fn.__self__
    step = driver.step

    def no_update(state, cam, target):
        return state, step.loss_and_grads(state.spheres, cam, target)[0]
    driver.step = no_update
    return fn


def frozen(fn):
    """The update applied to Adam's moments and count, the colours left as
    they were (an update written to a copy)."""
    driver = fn.__self__
    step = driver.step

    def colours_kept(state, cam, target):
        colour = state.spheres.color.detach().clone()
        state, loss = step(state, cam, target)
        with torch.no_grad():
            state.spheres.color.copy_(colour)
        return state, loss
    driver.step = colours_kept
    return fn


def unmasked(fn):
    """The masks ignored: the centres and radii move too."""
    driver = fn.__self__
    driver.step = _rebuilt(driver, trainable=False)
    return fn


class _Twice:
    """``torch.distributed`` whose all-reduce adds the sum a second time."""

    def __init__(self, dist):
        self._dist = dist

    def __getattr__(self, name):
        return getattr(self._dist, name)

    def all_reduce(self, t, *args, **kw):
        out = self._dist.all_reduce(t, *args, **kw)
        t.mul_(2.0)
        return out


def twice(fn):
    """The gradient and the loss summed twice by the all-reduce."""
    from raytracers_tpu_torch.parallel import mesh

    def unit(i):
        real, mesh.dist = mesh.dist, _Twice(mesh.dist)
        try:
            return fn(i)
        finally:
            mesh.dist = real
    return unit


def depth8(fn):
    """The program's paths cut at 8 segments, the reference's at the
    configuration's depth."""
    driver = fn.__self__
    driver.step = _rebuilt(driver, max_depth=8)
    return fn


FAULTS = {"half": half, "skipped": skipped, "frozen": frozen,
          "unmasked": unmasked, "twice": twice, "depth8": depth8}
