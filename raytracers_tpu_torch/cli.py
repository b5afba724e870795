"""Command-line driver with the reference flag contract.

Counterpart of ``raytracers_tpu.cli``.  Flags mirror the reference drivers
(futhark/main.c:34-57): ``-m height -n width -f out.ppm -s rgbbox|irreg
-r runs``, with ``--mode``, ``--leaf-size``, ``--depth``, ``--chunk``,
``--cpu``, ``--shard``, ``--native`` and ``--validate``.  It renders on the
CUDA card, or with ``--cpu`` through the plain PyTorch versions on the host,
or with ``--native`` through the native C++ renderer on the host CPU
(``native.py``, which builds it at first use):

    python -m raytracers_tpu_torch.cli -m 200 -n 200 -s irreg -f out.ppm

``--shard`` renders over the ray mesh (``parallel/mesh.py``): under
``torchrun``, over its process group, one card a process, and rank 0
prints and writes the image; alone, over a one-rank mesh:

    torchrun --nproc-per-node N -m raytracers_tpu_torch.cli --shard -s irreg

Output protocol of the reference driver:
    Using scene <s> (-s to switch).
    Timing over average of <r> runs (-r to change).
    Scene BVH construction in <t>s.
    Rendering in <t>s.
"""
from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="raytracers-tpu-torch",
                                description=__doc__.split("\n")[0])
    p.add_argument("-m", dest="height", type=int, default=200,
                   help="image height (reference -m)")
    p.add_argument("-n", dest="width", type=int, default=200,
                   help="image width (reference -n)")
    p.add_argument("-f", dest="imgfile", default=None,
                   help="write PPM (or PNG by extension) to this file "
                        "(reference -f)")
    p.add_argument("-s", dest="scene", default="rgbbox",
                   help="scene: rgbbox | irreg | plane (reference -s)")
    p.add_argument("-r", dest="runs", type=int, default=10,
                   help="timed runs per phase (reference -r)")
    p.add_argument("--mode", default="pallas",
                   choices=["bvh", "brute", "brute_matmul", "pallas"],
                   help="closest-hit engine (default: pallas, the "
                        "megakernel)")
    p.add_argument("--leaf-size", type=int, default=8,
                   help="BVH leaf cluster size (spheres per leaf)")
    p.add_argument("--depth", type=int, default=50,
                   help="max bounce depth (reference: 50)")
    p.add_argument("--chunk", type=int, default=None,
                   help="rays per batch of the bvh and brute tracers "
                        "(memory bound)")
    p.add_argument("--cpu", action="store_true",
                   help="run the plain PyTorch versions on the host")
    p.add_argument("--shard", action="store_true",
                   help="shard rays over the process group's ranks "
                        "(torchrun), or over one rank")
    p.add_argument("--native", action="store_true",
                   help="use the native C++ CPU renderer (built at first "
                        "use) instead of the port")
    p.add_argument("--validate", action="store_true",
                   help="run BVH/scene invariant checks before rendering")
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)

    from . import scenes
    from .bvh.lbvh import build_bvh
    from .image import write_image
    from .parallel.distributed import init
    from .parallel.mesh import ray_mesh, render_sharded
    from .render.api import prepare_scene, render
    from .utils.platform import resolve_device
    from .utils.timing import bench_fn
    from .utils.validate import validate_bvh, validate_spheres

    try:
        # the native renderer is a host program: its scene stays there
        device = resolve_device("cpu" if args.cpu or args.native else None)
        scene = scenes.by_name(args.scene, device=device)
    except RuntimeError as e:
        print(f"{e} (the --cpu flag)", file=sys.stderr)
        return 1
    except ValueError as e:
        # reference driver behaviour: a message and a nonzero exit
        # (futhark/main.c:78-81), not a traceback
        print(e, file=sys.stderr)
        return 1
    mesh = None
    if args.shard and not args.native:
        init(device=device)
        mesh = ray_mesh(device=device)
    lead = mesh is None or mesh.rank == 0       # the rank that reports

    def say(msg, file=sys.stdout):
        if lead:
            print(msg, file=file)

    if args.validate:
        problems = validate_spheres(scene.spheres) + validate_bvh(
            build_bvh(scene.spheres, leaf_size=args.leaf_size))
        if problems:
            print("VALIDATION FAILED:", *problems, sep="\n  ",
                  file=sys.stderr)
            return 2
        say("validation: scene and BVH invariants OK", file=sys.stderr)
    say(f"Using scene {args.scene} (-s to switch).")
    say(f"Timing over average of {args.runs} runs (-r to change).")

    if args.native:
        from . import native
        try:
            bvh_ms, render_ms, img = native.bench(
                scene.spheres, scene.look_from, scene.look_at, scene.fov,
                args.width, args.height, max_depth=args.depth,
                runs=args.runs)
        except native.NativeUnavailable as e:
            print(e, file=sys.stderr)
            return 1
        say(f"Scene BVH construction in {bvh_ms / 1e3:f}s.")
        say(f"Rendering in {render_ms / 1e3:f}s.")
        say(f"(native C++ renderer on the host CPU: {native.host_cpu()})",
            file=sys.stderr)
    else:
        def prepare():
            return prepare_scene(scene, args.height, args.width,
                                 leaf_size=args.leaf_size,
                                 with_pallas=args.mode == "pallas",
                                 device=device)

        bvh_s = bench_fn(prepare, runs=args.runs)
        say(f"Scene BVH construction in {bvh_s:f}s.")
        prep = prepare()

        def draw():
            if mesh is not None:
                return render_sharded(prep, args.height, args.width,
                                      mesh=mesh, mode=args.mode,
                                      max_depth=args.depth)
            return render(prep, args.height, args.width, mode=args.mode,
                          max_depth=args.depth, chunk=args.chunk)

        render_s = bench_fn(draw, runs=args.runs)
        say(f"Rendering in {render_s:f}s.")
        rays = args.width * args.height / render_s
        say(f"({rays / 1e6:.1f} Mrays/s on {device.type}"
            + (f", {mesh.size} ranks)" if mesh is not None else ")"),
            file=sys.stderr)
        img = draw()

    if args.imgfile is None:
        say("-f not passed, so not writing image to file")
    elif lead:
        say(f"Writing image to {args.imgfile}.")
        write_image(args.imgfile, img)
    return 0

if __name__ == "__main__":
    sys.exit(main())
