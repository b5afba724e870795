"""Multi-process initialisation over ``torch.distributed``.

Counterpart of ``raytracers_tpu.parallel.distributed``.  Call :func:`init`
once per process before building the mesh; ``parallel/mesh.ray_mesh()``
then spans every process, one device a process: NCCL between cards, gloo
between CPU processes.  Under ``torchrun`` the process group's address,
size and rank come from its environment:

    torchrun --nproc-per-node N -m raytracers_tpu_torch.cli --shard ...

``dryrun_multichip(n)`` runs one sharded train step of each kind over n
processes started here.
"""
from __future__ import annotations

import math
import os
import socket
import time

import torch
import torch.distributed as dist

from ..utils.platform import resolve_device

DRYRUN_TIMEOUT_S = 120.0        # each process of dryrun_multichip


def init(coordinator_address: str | None = None,
         num_processes: int | None = None,
         process_id: int | None = None, device=None) -> dict:
    """Join the process group of ``num_processes`` processes at
    ``coordinator_address`` ("host:port") as ``process_id``; unset, they
    come from torchrun's ``WORLD_SIZE``, ``RANK`` and ``MASTER_ADDR`` /
    ``MASTER_PORT``.  A single process with no coordinator initialises
    nothing, as JAX's does.  The backend is NCCL where ``device`` (default:
    the card) is a CUDA device, whose index is then ``LOCAL_RANK`` (or the
    rank modulo the cards here), and gloo on the CPU.  Returns a summary
    dict."""
    env = os.environ
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", 1))
    if process_id is None:
        process_id = int(env.get("RANK", 0))
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    device = resolve_device(device)
    if not dist.is_initialized() and (num_processes > 1
                                      or coordinator_address is not None):
        if coordinator_address is None:
            raise ValueError(f"{num_processes} processes need a "
                             "coordinator address")
        backend = "gloo"
        if device.type == "cuda":
            backend = "nccl"
            local = int(env.get("LOCAL_RANK", process_id
                                % torch.cuda.device_count()))
            torch.cuda.set_device(local)
        dist.init_process_group(backend,
                                init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    count = dist.get_world_size() if dist.is_initialized() else 1
    return {
        "process_index": dist.get_rank() if dist.is_initialized() else 0,
        "process_count": count,
        "local_devices": 1,
        "global_devices": count,
    }


def scaling_efficiency(single_chip_rays_per_s: float,
                       n_chip_rays_per_s: float, n_chips: int) -> float:
    """Scaling efficiency metric from BASELINE.json (target >= 0.85)."""
    return n_chip_rays_per_s / (single_chip_rays_per_s * n_chips)


def free_address() -> str:
    """A free localhost "host:port" for a process group's rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def _dryrun_rank(rank: int, n: int, address: str, device: str,
                 results) -> None:
    """One process of ``dryrun_multichip``: the three sharded paths of
    ``__graft_entry__.dryrun_multichip`` on a tiny scene."""
    if device == "cpu":
        torch.set_num_threads(1)
    init(address, n, rank, device=device)
    try:
        from ..geometry import Spheres, camera
        from ..grad.inverse import (adam, init_state, make_train_step,
                                    make_train_step_pallas)
        from ..render.megakernel import build_pallas_scene
        from ..render.tracer import primary_rays
        from .mesh import ray_mesh, render_pallas_sharded

        mesh = ray_mesh(device=device)
        dev = mesh.device
        spheres = Spheres(
            torch.tensor([[0.0, 0.0, -5.0], [2.5, 0.0, -4.0],
                          [-2.0, 1.0, -6.0], [0.5, -1.5, -4.5]], device=dev),
            torch.tensor([1.5, 1.0, 0.8, 0.6], device=dev),
            torch.tensor([[0.8, 0.3, 0.2], [0.2, 0.6, 0.9],
                          [0.9, 0.9, 0.1], [0.4, 0.8, 0.4]], device=dev))
        cam = camera((0., 0., 2.), (0., 0., -5.), (0., 1., 0.), 60.0, 1.0,
                     device=dev)
        H = W = 16
        origins, dirs = primary_rays(cam, W, H)
        state, loss = make_train_step(mesh, max_depth=3)(
            init_state(spheres, adam(1e-2)), origins, dirs,
            torch.zeros(H * W, 3, device=dev))
        # the megakernel's survivor compaction, sharded: phases, prefixed
        # boundary sorts, the final unpermute
        img = render_pallas_sharded(build_pallas_scene(spheres), cam, 64, 64,
                                    mesh=mesh, max_depth=18, schedule=(3, 6),
                                    sort_prefix=(None, 0.5))
        loss_p = None
        if H % n == 0:
            state_p, loss_p = make_train_step_pallas(mesh, W, H, max_depth=2)(
                init_state(spheres, adam(1e-2)), cam,
                torch.zeros(H, W, 3, device=dev))
            loss_p = float(loss_p)
        results.put((rank, float(loss), loss_p, tuple(img.shape),
                     float(state.spheres.radius.sum())))
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device: str = "cuda") -> list[tuple]:
    """One sharded train step over an all-pairs oracle, a sharded deep
    megakernel render and one sharded train step of the megakernel's
    fwd+bwd engine, on ``n_devices`` processes: one card each
    (``device="cuda"``) or gloo on the CPU.  Every process must finish
    within ``DRYRUN_TIMEOUT_S`` with a finite loss, the same on every
    rank.
    Returns each rank's (rank, loss, megakernel step's loss or None where
    16 rows do not split over the ranks, image shape, radius sum after the
    step)."""
    import multiprocessing as mp
    import queue

    if device == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"need {n_devices} cards, have "
                           f"{torch.cuda.device_count()}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    address = free_address()
    procs = [ctx.Process(target=_dryrun_rank,
                         args=(r, n_devices, address, device, results))
             for r in range(n_devices)]
    for p in procs:
        p.start()
    out = []
    deadline = time.monotonic() + DRYRUN_TIMEOUT_S
    try:
        while len(out) < n_devices:
            try:
                out.append(results.get(timeout=1.0))
            except queue.Empty:
                codes = [p.exitcode for p in procs]
                if (any(c not in (None, 0) for c in codes)
                        or time.monotonic() > deadline):
                    raise RuntimeError(
                        f"dryrun: {len(out)} of {n_devices} processes "
                        f"reported; exit codes {codes}") from None
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"dryrun: processes exited with {bad}")
    out.sort()
    if (len({(r[1], r[2], r[4]) for r in out}) != 1
            or not math.isfinite(out[0][1])
            or not math.isfinite(out[0][2] or 0.0)):
        raise RuntimeError(f"dryrun: ranks disagree or diverged: {out}")
    return out
