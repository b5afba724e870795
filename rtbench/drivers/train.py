"""``train``: steps of one inverse-rendering fit, one client, a closed loop
(a step ends when the host has synchronised with the card, and only then
is the next submitted).

Set-up makes a one-rank process group where none is initialised (the
configuration's ``mesh`` backend on the card, gloo on the host, over a
``HashStore``) and the mesh over it (``ray_mesh``); renders the target
once with the plain reference from the suite's scene and colours, on the
device (the fit's input, as a user's photograph is); draws the start from
the seed: every channel of the suite's colours moved by up to
``colour_offset`` and clipped to [0, 1], the centres and radii as the
suite has them; and builds the trainer through the port's own API:
``make_train_step_pallas(mesh, w, h, max_depth, trainable, **engine)``
with the mix's masks and the engine of ``pallas_diff_config``, and
``init_state(start, adam(lr))``, whose Adam has to run at the mix's
``b1``, ``b2`` and ``eps``.

The units are the steps of that one fit: the state rolls through the
warm-up and the window, as in a user's fit of hundreds of steps.  Step i
calls ``step(state, cam, target)`` and then copies the state (the three
leaves and six moments) into one vector on the device, with Adam's
count; that copy is the state before step i + 1, so that ``inputs(i)``
and ``reference(i)`` can replay any step the harness keeps
(``reference_train.step``).  The copies before step 0, before each of
the first ``check_within`` steps of the window, and before the latest
step are kept.

A fit converges within a few hundred steps, and there the program's step
and the reference's part by what their float32 renders differ in (a few
pixels settled differently; PERF.md §2) while the step itself shrinks.
So the loss and the moment are taken relative to what does not shrink,
the target's energy and the reference's own first step of the fit
(``reference`` computes it once, in float32), and the update is held to
Adam's formula:

* ``loss``: |L - L_ref| / sum(target²);
* ``moment_colour``: ‖m - m_ref‖ of the colours' first moment after the
  step, over the reference's after its first step, (1 - b1) ‖g_ref,0‖:
  it is linear in the all-reduced gradient, so a gradient counted twice
  shows here, where Adam's scale-free update would hide it;
* ``update_colour``: ‖c - c_adam‖ / ‖c_adam - c_before‖, where c_adam
  is Adam's update as the reference writes it (``reference_train
  .adam_apply``, then the clamp) applied to the colours before the step
  from the moments and the count the program holds after it: the
  colours have to move as the moments say.  A fit's colours move by the
  reference's moments only as far as its gradient agrees, and at a
  converged fit that is not far (PERF.md §2), so the update is held to
  the program's own moments, which ``moment_colour`` and ``count`` hold
  to the reference's.  A state left unchanged while the moments and the
  count advance reads 1;
* ``geometry_moved``: the largest |Δ| of a centre or radius over the
  step;
* ``count``: |count - count_ref|.

``calibrate``'s planted faults and its float64 look key on the ``step``
driver's fields (``target``, ``variants``, ``f``); this driver names its
own otherwise, so neither runs on it.  Its faults are
``rtbench/train_faults.py``'s.
"""
from __future__ import annotations

import math

import torch

from rtbench import check, reference, reference_train, scenes


def _engine(n_clusters: int, max_depth: int) -> dict:
    """``pallas_diff_config``'s engine, its schedule's phases ending
    before ``max_depth`` (all of them at the configuration's depth)."""
    from raytracers_tpu_torch.render.api import pallas_diff_config
    tile, block, schedule, prefix = pallas_diff_config(n_clusters)
    keep, total = 0, 0
    for depth in schedule:
        if total + depth >= max_depth:
            break
        total += depth
        keep += 1
    return dict(tile=tile, block=block, schedule=tuple(schedule[:keep]),
                sort_prefix=tuple(prefix[:keep]))


class Driver:
    def __init__(self, config: dict, mix: dict, seed: int, device):
        import torch.distributed as dist

        from raytracers_tpu_torch.geometry import Camera, Spheres
        from raytracers_tpu_torch.grad.inverse import (
            adam, init_state, make_train_step_pallas)
        from raytracers_tpu_torch.parallel.mesh import ray_mesh
        from raytracers_tpu_torch.render.megakernel import build_pallas_scene
        self.mix, self.device = mix, device
        self.W, self.H, self.D = (config["width"], config["height"],
                                  config["max_depth"])
        if config["mesh"]["ranks"] != 1:
            raise ValueError("the train driver runs a one-rank mesh")
        cuda = device.type == "cuda"
        self.owns_group = not dist.is_initialized()
        if self.owns_group:
            if cuda:
                torch.cuda.set_device(device)
            dist.init_process_group(
                config["mesh"]["backend"] if cuda else "gloo",
                store=dist.HashStore(), rank=0, world_size=1)
        self.mesh = ray_mesh(device=device)

        suite = scenes.spheres(config, device)
        self.cam = scenes.camera(config, device)
        self.goal, _ = reference.trace(suite, self.cam, self.W, self.H,
                                       self.D)
        centre, radius, colour = suite
        b = mix["colour_offset"]
        g = scenes.generator(seed, device)
        start = (centre, radius,
                 (colour + scenes.uniform(g, colour.shape, -b, b, device))
                 .clamp(0.0, 1.0))
        self.masks = tuple(torch.full_like(t, mix["trainable"][name])
                           for name, t in zip(reference_train.LEAVES, suite))
        self.n_clusters = build_pallas_scene(Spheres(*suite)).n_clusters
        self.engine = _engine(self.n_clusters, self.D)
        self.step = make_train_step_pallas(
            self.mesh, self.W, self.H, max_depth=self.D,
            trainable=Spheres(*self.masks), **self.engine)
        self.state = init_state(Spheres(*start), adam(mix["lr"]))
        group = self.state.opt.param_groups[0]
        if (group["lr"], tuple(group["betas"]), group["eps"]) != (
                mix["lr"], (mix["b1"], mix["b2"]), mix["eps"]):
            raise ValueError(f"the program's Adam runs at lr {group['lr']}"
                             f", betas {group['betas']}, eps "
                             f"{group['eps']}, not the mix's")
        self.camera = Camera(*self.cam)
        self.like = suite
        self.before: dict = {}
        self.keep_until = mix["warmup_units"] + mix["check_within"]
        self.latest = (self._snapshot(), 0)
        self._first_moment = None

    def _snapshot(self) -> torch.Tensor:
        """The state's leaves and moments in one vector on the device."""
        st = self.state
        moments = [st.opt.state.get(p, {}) for p in st.spheres]
        return torch.cat(
            [p.detach().reshape(-1) for p in st.spheres]
            + [s["exp_avg"].reshape(-1) if s else torch.zeros_like(p)
               .reshape(-1) for s, p in zip(moments, st.spheres)]
            + [s["exp_avg_sq"].reshape(-1) if s else torch.zeros_like(p)
               .reshape(-1) for s, p in zip(moments, st.spheres)])

    def _count(self) -> int:
        s = self.state.opt.state.get(self.state.spheres[0])
        return int(s["step"]) if s else 0

    def run(self, i: int):
        before = self.latest
        self.before[i] = before
        if i - 1 >= self.keep_until:
            self.before.pop(i - 1, None)
        self.state, loss = self.step(self.state, self.camera, self.goal)
        self.latest = (self._snapshot(), self._count())
        return before, loss, self.latest

    def wait(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def inputs(self, i: int) -> reference_train.State:
        """The state before step i."""
        flat, count = self.before[i]
        return reference_train.State.unflat(flat, count, self.like)

    def release(self):
        """Drop the program's state (the trainer, its state and the mesh),
        and the process group where this driver made it."""
        import torch.distributed as dist
        self.step = self.state = self.mesh = None
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self.owns_group = False

    def _reference_step(self, i: int, dtype):
        return reference_train.step(
            self.inputs(i), self.masks, self.mix, self.cam, self.goal,
            self.W, self.H, self.D, dtype=dtype)

    def first_moment(self) -> float:
        """‖m‖ of the colours' first moment after the reference's own
        first step of the fit, in float32 (``compare``'s scale of the
        moment)."""
        if self._first_moment is None:
            new, _, _ = self._reference_step(0, torch.float32)
            self._first_moment = float(new.m[2].double().norm())
        return self._first_moment

    def reference(self, i: int, dtype=torch.float32):
        """The reference's step i from the same state, in the program's
        form (the state before it, the loss, the new state as one vector
        and its count), and its trace's info with what ``compare`` needs
        besides: the target's energy, ``first_moment`` and Adam's
        settings."""
        new, loss, info = self._reference_step(i, dtype)
        info.update(
            target_energy=float((self.goal.double() ** 2).sum()),
            first_moment=self.first_moment(),
            adam={k: self.mix[k] for k in ("lr", "b1", "b2", "eps")})
        return (self.before[i], loss, (new.flat(), new.count)), info

    @staticmethod
    def compare(out, ref, info) -> dict:
        (before, loss, after) = out
        (_, ref_loss, (ref_flat, ref_count)) = ref
        (flat, count) = after
        pre, post, want = (x.to(ref_flat.device).double()
                           for x in (before[0], flat, ref_flat))
        n = pre.numel() // 21   # a sphere: 7 values, and 7 of each moment
        geometry = slice(0, 4 * n)
        colour = slice(4 * n, 7 * n)
        m_colour = slice(11 * n, 14 * n)
        v_colour = slice(18 * n, 21 * n)
        a = info["adam"]
        adam = (reference_train.adam_apply(
            pre[colour], post[m_colour], post[v_colour], count, a["lr"],
            a["b1"], a["b2"], a["eps"]).clamp(*reference_train.COLOUR_CLIP)
            if count else pre[colour])
        numbers = dict(
            loss=abs(float(loss.double()) - float(ref_loss.double()))
            / info["target_energy"],
            moment_colour=_rel(post[m_colour], want[m_colour],
                               info["first_moment"]),
            update_colour=_rel(post[colour], adam,
                               float((adam - pre[colour]).norm())),
            geometry_moved=float((post[geometry] - pre[geometry]).abs()
                                 .max()),
            count=float(abs(count - ref_count)))
        return {k: check._finite(v) for k, v in numbers.items()}


def _rel(a, b, scale: float) -> float:
    """‖a - b‖ / scale (0 where a equals b)."""
    num = float((a - b).norm())
    return num / scale if scale else (0.0 if num == 0 else math.inf)
