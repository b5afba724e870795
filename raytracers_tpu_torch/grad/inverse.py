"""Inverse rendering: recover sphere parameters from a target image by
pixel-gradient descent (BASELINE.json configs[4]).

Counterpart of ``raytracers_tpu.grad.inverse``.  The train step is sharded
over the ray mesh (``parallel/mesh.py``): each rank renders and
differentiates its share of the rays, then the loss and the sphere
gradients are summed over the ranks by one all-reduce, the counterpart of
JAX's ``psum``.  The spheres and the optimizer's state are replicated, so
every rank applies the same update.

The optimizer lives in the state, as torch keeps an optimizer's moments
beside its parameters: ``InverseState(spheres, opt)``, made by
``init_state(spheres, adam(lr))``, where ``adam`` is ``torch.optim.Adam``
at ``optax.adam``'s defaults.  A step updates the state's tensors in place
and returns the state.  One Adam step differs from optax's by rounding
only (torch uses ``lerp_`` and ``addcdiv_``), so trajectories of the two
packages part slowly; gradients and single steps agree.

Under torch.profiler a step runs in the span ``rt.train``, its all-reduce in
``rt.allreduce`` (``parallel/mesh.py``) and its update (the masks, Adam,
the clamps) in ``rt.optim``; under ``utils.trace.counting()`` each step adds
one to ``train.steps``.

As in the JAX package, the gradient is exact for the continuous shading
terms but omits the visibility boundary term: colour and radius recovery
converge, pure centre recovery needs ``grad/soft_render.py``.
"""
from __future__ import annotations

import functools
import os
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..geometry import Camera, Spheres
from ..parallel.mesh import RayMesh, all_sum
from ..render.bruteforce import make_closest_hit
from ..render.tracer import primary_rays
from ..utils.trace import count, span, spanned
from .diff_render import trace_diff


def adam(lr: float) -> Callable:
    """``optax.adam(lr)``'s counterpart: a factory of ``torch.optim.Adam``
    over the tensors it is given, at optax's defaults."""
    return functools.partial(torch.optim.Adam, lr=lr, betas=(0.9, 0.999),
                             eps=1e-8)


class InverseState(NamedTuple):
    spheres: Spheres                   # the optimizer's parameters
    opt: torch.optim.Optimizer

    def leaves(self) -> list[torch.Tensor]:
        """The JAX package's leaves of ``InverseState(spheres,
        optax.adam(lr).init(spheres))``, in its order: centre, radius,
        colour, Adam's count (int32), the three first moments, the three
        second moments."""
        st = [self.opt.state.get(p, {}) for p in self.spheres]
        count = int(st[0]["step"]) if st[0] else 0
        return [*(p.detach() for p in self.spheres),
                torch.tensor(count, dtype=torch.int32),
                *(s["exp_avg"] if s else torch.zeros_like(p)
                  for s, p in zip(st, self.spheres)),
                *(s["exp_avg_sq"] if s else torch.zeros_like(p)
                  for s, p in zip(st, self.spheres))]

    def load_leaves(self, leaves) -> None:
        """Set the spheres and Adam's count and moments from ``leaves`` in
        ``leaves()``'s order (numpy arrays or tensors), in place."""
        def t(x, like):
            if not isinstance(x, torch.Tensor):
                x = torch.from_numpy(np.array(x))
            return x.to(device=like.device, dtype=like.dtype).reshape(
                like.shape)
        with torch.no_grad():
            for p, x in zip(self.spheres, leaves[:3]):
                p.copy_(t(x, p))
        count = float(int(leaves[3]))
        for i, p in enumerate(self.spheres):
            self.opt.state[p] = {
                "step": torch.tensor(count, dtype=torch.float32),
                "exp_avg": t(leaves[4 + i], p).clone(),
                "exp_avg_sq": t(leaves[7 + i], p).clone()}


def init_state(spheres: Spheres, optimizer: Callable) -> InverseState:
    """A fresh state: copies of ``spheres`` and ``optimizer(params)`` over
    them (e.g. ``adam(lr)``); ``spheres`` itself is not changed."""
    params = Spheres(*(t.detach().clone() for t in spheres))
    return InverseState(params, optimizer(list(params)))


def band_camera(cam: Camera, row0, rows: int, total_height: int) -> Camera:
    """Camera whose (w x rows) image is rows [row0, row0+rows) of ``cam``'s
    (w x total_height) image (inverse.py:49-64).

    The pixel->ray map is affine in the row index (v = (h - j)/h), so a
    band is a linear reparameterisation: vertical' = vertical * rows/H and
    llc' = llc + vertical * (H - rows - row0)/H, the full image's
    directions up to one float32 rounding.  With one band (rows = H,
    row0 = 0) the camera is unchanged bit for bit."""
    f32 = dict(dtype=torch.float32, device=cam.origin.device)
    s = torch.tensor(rows / total_height, **f32)
    shift = ((torch.tensor(float(total_height - rows), **f32)
              - torch.as_tensor(row0, **f32))
             * torch.tensor(1.0 / total_height, **f32))
    return cam._replace(vertical=cam.vertical * s,
                        llc=cam.llc + cam.vertical * shift)


def _leaf_grads(loss_fn, spheres: Spheres) -> list:
    """[loss, d/dcentre, d/dradius, d/dcolour] of ``loss_fn(spheres)``."""
    with torch.enable_grad():
        sph = Spheres(*(t.detach().requires_grad_(True) for t in spheres))
        loss = loss_fn(sph)
        grads = torch.autograd.grad(loss, sph)
    return [loss.detach(), *grads]


@spanned("rt.optim")
def _apply_update(state: InverseState, grads: Spheres, loss, trainable):
    """One optimizer step: gradients masked by ``trainable`` (a masked
    leaf's moments still move, as optax's do), then radius >= 1e-2 and
    colour clipped to [0, 1]."""
    masks = trainable if trainable is not None else (None,) * 3
    for p, g, m in zip(state.spheres, grads, masks):
        p.grad = g if m is None else g * torch.as_tensor(
            m, dtype=g.dtype, device=g.device)
    state.opt.step()
    with torch.no_grad():
        state.spheres.radius.clamp_(min=1e-2)
        state.spheres.color.clamp_(0.0, 1.0)
    for p in state.spheres:
        p.grad = None
    return state, loss


def _target(target_image, cam: Camera) -> torch.Tensor:
    """A target image (tensor or array) as float32 on the camera's device."""
    if not isinstance(target_image, torch.Tensor):
        target_image = np.array(target_image, dtype=np.float32)
    return torch.as_tensor(target_image, dtype=torch.float32,
                           device=cam.origin.device)


def make_train_step_pallas(mesh: RayMesh, width: int, height: int,
                           max_depth: int = 5,
                           trainable: Spheres | None = None, **diff_kwargs):
    """Sharded train step whose fwd+bwd engine is the megakernel's
    (``grad/pallas_diff.py``: K1d forward, K2 backward): each rank renders
    and differentiates a horizontal band of the image through a
    ``band_camera``, and the loss and sphere gradients are all-reduced
    over the mesh.

    Returns step: (state, cam, target_image (h, w, 3)) -> (state, loss).
    ``step.loss_and_grads(spheres, cam, target_image)`` gives the summed
    (loss, Spheres of gradients); ``step.rank_loss_and_grads(rank, ...)``
    rank ``rank``'s share of them, the body each rank runs."""
    from .pallas_diff import make_render_pallas_diff

    n = mesh.size
    if height % n:
        raise ValueError(f"height {height} not divisible by mesh size {n}")
    rows_per = height // n
    rdiff = make_render_pallas_diff(width, rows_per, max_depth=max_depth,
                                    **diff_kwargs)

    def rank_loss_and_grads(rank: int, spheres: Spheres, cam: Camera,
                            target_image) -> list:
        camb = band_camera(cam, float(rank * rows_per), rows_per, height)
        band = _target(target_image, cam)[rank * rows_per:
                                          (rank + 1) * rows_per]
        return _leaf_grads(lambda s: ((rdiff(s, camb) - band) ** 2).sum(),
                           spheres)

    def loss_and_grads(spheres: Spheres, cam: Camera, target_image):
        target = _target(target_image, cam)
        loss, *grads = all_sum(mesh, lambda r: rank_loss_and_grads(
            r, spheres, cam, target))
        return loss, Spheres(*grads)

    def step(state: InverseState, cam: Camera, target_image):
        with span("rt.train"):
            count("train.steps", 1)
            loss, grads = loss_and_grads(state.spheres, cam, target_image)
            return _apply_update(state, grads, loss, trainable)

    step.loss_and_grads = loss_and_grads
    step.rank_loss_and_grads = rank_loss_and_grads
    return step


def make_train_step(mesh: RayMesh, max_depth: int = 5,
                    oracle_mode: str = "brute",
                    trainable: Spheres | None = None):
    """Sharded train step over an all-pairs oracle, "brute" or
    "brute_matmul": (state, origins (R,3), dirs (R,3), target (R,3)) ->
    (state, loss).  R must be divisible by the mesh size; each rank takes
    a contiguous slice of the rays (``step.rank_loss_and_grads(rank,
    spheres, origins, dirs, target)``), and the gradients are all-reduced,
    so every rank applies the same update."""
    formulation = {"brute": "precise", "brute_matmul": "matmul"}.get(
        oracle_mode)
    if formulation is None:
        raise ValueError(oracle_mode)

    def rank_loss_and_grads(rank, spheres, origins, dirs, target) -> list:
        per = origins.shape[0] // mesh.size
        rows = slice(rank * per, (rank + 1) * per)

        def loss_fn(sph):
            ch = make_closest_hit(sph, formulation)
            colours = trace_diff(ch, sph, origins[rows], dirs[rows],
                                 max_depth)
            return ((colours - target[rows]) ** 2).sum()
        return _leaf_grads(loss_fn, spheres)

    def step(state: InverseState, origins, dirs, target):
        if origins.shape[0] % mesh.size:
            raise ValueError(f"{origins.shape[0]} rays not divisible by "
                             f"mesh size {mesh.size}")
        with span("rt.train"):
            count("train.steps", 1)
            loss, *grads = all_sum(mesh, lambda r: rank_loss_and_grads(
                r, state.spheres, origins, dirs, target))
            return _apply_update(state, Spheres(*grads), loss, trainable)

    step.rank_loss_and_grads = rank_loss_and_grads
    return step


def recover(target_image, cam: Camera, init_spheres: Spheres, mesh: RayMesh,
            steps: int = 100, lr: float = 1e-2, max_depth: int = 5,
            oracle_mode: str = "brute", trainable: Spheres | None = None,
            callback: Callable | None = None,
            checkpoint_dir: str | None = None,
            checkpoint_every: int = 50) -> tuple[Spheres, float]:
    """Fit sphere parameters to a target (h, w, 3) float image.

    ``trainable``: optional Spheres of 0/1 masks selecting which
    parameters receive gradient updates.  ``callback(i, loss, spheres)``
    gets the state's tensors, which later steps update in place.

    ``checkpoint_dir``: when set, the full training state (spheres + Adam
    moments) is saved every ``checkpoint_every`` steps, in the JAX
    package's file format, and the fit resumes from the latest checkpoint
    found there: a restarted run continues with identical optimizer
    state."""
    h, w = target_image.shape[:2]
    origins, dirs = primary_rays(cam, w, h)
    target = _target(target_image, cam).reshape(-1, 3)
    R = origins.shape[0]
    if R % mesh.size:
        pad = mesh.size - R % mesh.size
        origins = torch.cat([origins, origins[:pad]])
        dirs = torch.cat([dirs, dirs[:pad]])
        target = torch.cat([target, target[:pad]])

    state = init_state(init_spheres, adam(lr))
    start, loss = 0, float("inf")
    if checkpoint_dir is not None:
        from ..utils import checkpoint as ckpt
        os.makedirs(checkpoint_dir, exist_ok=True)
        latest = ckpt.latest_checkpoint(checkpoint_dir)
        if latest is not None:
            # the loss too: a resume with start >= steps runs no step and
            # must not report inf for a converged fit
            state, start, loss = ckpt.load_train_state(latest, state)
    step = make_train_step(mesh, max_depth, oracle_mode, trainable)
    for i in range(start, steps):
        state, loss = step(state, origins, dirs, target)
        if callback is not None:
            callback(i, float(loss), state.spheres)
        if (checkpoint_dir is not None
                and ((i + 1) % checkpoint_every == 0 or i + 1 == steps)):
            ckpt.save_train_state(
                os.path.join(checkpoint_dir, f"ckpt_{i + 1}"), state, i + 1,
                loss=float(loss))
    return state.spheres, float(loss)
