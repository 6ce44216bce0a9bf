"""Command-line interface of the PyTorch/CUDA port.

Mirrors the JAX package's ``designcsg_tpu.cli`` for the commands the port
has::

    python -m designcsg_tpu_torch.cli render design1 -o out.png
    python -m designcsg_tpu_torch.cli render design2 --fast
    python -m designcsg_tpu_torch.cli render path/to/mydesign.py --orbit -0.785 0.785
    python -m designcsg_tpu_torch.cli export design1 --stl out.stl --ply out.ply
    python -m designcsg_tpu_torch.cli export design2 --strategy active --grid-level 9
    python -m designcsg_tpu_torch.cli preview out.stl preview.png  # look at a mesh
    python -m designcsg_tpu_torch.cli export logo --sdf-field baked  # the kernels' field
    python -m designcsg_tpu_torch.cli artifacts design1 -d build/   # reference IR
    python -m designcsg_tpu_torch.cli fit design1 --steps 150       # shape fit demo
    python -m designcsg_tpu_torch.cli watch mydesign.py -o live.png  # edit-run loop
    python -m designcsg_tpu_torch.cli studio workspace/              # browser shell

Every command runs on the card; ``--device cpu`` takes the plain PyTorch
path (the JAX CLI's ``--backend`` choice).  A design is a builtin name
(design1 | design2 | logo) or the path of a Python design script that either defines
``build() -> CompiledScene`` or calls the port's module-level API
(``designcsg_tpu_torch.api``: ``new_design() ... commit()``) when imported.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import os
import struct
import sys
import time
import zlib

import numpy as np

BUILTIN = ("design1", "design2", "logo")

# ``export --sdf-field``: the evaluator's engine (cli.py:172-177 of the JAX
# package): its own rule, the kernels' (baked) field, or the exact tape.
SDF_FIELDS = {"auto": None, "baked": True, "exact": False}

# Commands of the JAX CLI not ported yet, with the ROADMAP.md item that
# brings each.
UNPORTED = {
    "bench": "queue 1, item 11 (no benchmark of the port yet)",
}


def load_design(spec: str):
    """Resolve a design spec (builtin name or script path) to a CompiledScene."""
    from . import api
    from .designs import get_design

    if spec.lower() in BUILTIN:
        return get_design(spec)
    if not os.path.exists(spec):
        raise FileNotFoundError(f"design {spec!r}: not a builtin name or a file")
    module_name = os.path.splitext(os.path.basename(spec))[0]
    sys.path.insert(0, os.path.dirname(os.path.abspath(spec)) or ".")
    spec_obj = importlib.util.spec_from_file_location(module_name, spec)
    module = importlib.util.module_from_spec(spec_obj)
    api.new_design()
    spec_obj.loader.exec_module(module)
    if hasattr(module, "build"):
        return module.build()
    # Script-style design: it drew into the current compiler (committing
    # again is idempotent: the tree is intact).
    return api.commit()


def _camera(args):
    from .camera import Camera

    cam = Camera.initial(apply_default_orbit=not getattr(args, "no_default_orbit", False))
    if getattr(args, "orbit", None):
        cam.orbit(args.orbit[0], args.orbit[1])
    if getattr(args, "zoom", 0.0):
        cam.zoom(args.zoom)
    return cam


def png_bytes(rgb: np.ndarray) -> bytes:
    """u8[H, W, 3] (or u8[H, W]) as the bytes of an 8-bit PNG, made with the
    standard library's zlib: one IHDR, one IDAT of unfiltered rows, IEND."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    height, width = rgb.shape[:2]
    color = 2 if rgb.ndim == 3 else 0

    def chunk(kind: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + kind + data + struct.pack(
            ">I", zlib.crc32(kind + data) & 0xFFFFFFFF
        )

    rows = np.concatenate([np.zeros((height, 1), np.uint8), rgb.reshape(height, -1)], axis=1)
    return b"".join([
        b"\x89PNG\r\n\x1a\n",
        chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, color, 0, 0, 0)),
        chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)),
        chunk(b"IEND", b""),
    ])


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write u8[H, W, 3] (or u8[H, W]) as an 8-bit PNG (:func:`png_bytes`)."""
    with open(path, "wb") as f:
        f.write(png_bytes(rgb))


def read_png(path: str) -> np.ndarray:
    """Read back an 8-bit RGB or grey PNG with unfiltered rows, as
    :func:`write_png` writes it."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def decode_png(data: bytes, name: str = "data") -> np.ndarray:
    """The pixels of PNG bytes as :func:`png_bytes` makes them; ``name``
    labels errors."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{name} is not a PNG file")
    pos, idat, header = 8, b"", None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + length]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + length
    width, height, depth, color = header[:4]
    channels = {0: 1, 2: 3}[color]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(height, 1 + width * channels)
    if depth != 8 or rows[:, 0].any():
        raise ValueError(f"{name}: only 8-bit PNGs with unfiltered rows are read")
    img = rows[:, 1:].reshape(height, width, channels)
    return img if channels == 3 else img[..., 0]


def fast_config(config):
    """``render --fast``: over-relaxed stepping at omega = 1.6, plus the
    hierarchical cone prepass when the viewport divides by its factor (both
    hit-preserving; cli.py:70-85 of the JAX package)."""
    config = dataclasses.replace(config, march_overrelax=1.6)
    f = config.hierarchical_factor
    if config.width % f == 0 and config.height % f == 0:
        config = dataclasses.replace(config, march_hierarchical=True)
    return config


def cmd_render(args):
    from . import resolve_device
    from .config import RenderConfig
    from .ops.raymarch import make_scene_renderer, to_u8

    scene = load_design(args.design)
    config = RenderConfig(width=args.width, height=args.height, gizmo=not args.no_gizmo)
    if args.fast:
        config = fast_config(config)
    cam = _camera(args)
    t0 = time.time()
    renderer = make_scene_renderer(scene, config, resolve_device(args.device))
    img = renderer(scene.arrays.to_torch(args.device), *cam.as_arrays())
    u8 = to_u8(img).cpu().numpy()
    print(f"rendered {config.width}x{config.height} in {time.time() - t0:.2f}s "
          f"(engine: {renderer.engine})")
    write_png(args.output, u8)
    print(f"wrote {args.output}")


def cmd_watch(args):
    """Edit-run loop (cli.py:121-152 of the JAX package): re-render the
    design script whenever its mtime changes, printing the render time or
    the script's exception (the reference's File->Run and log.txt).
    ``--max-renders`` stops after that many renders (0: until
    interrupted)."""
    if not os.path.exists(args.design):
        raise FileNotFoundError(f"watch needs a design script path: {args.design!r}")
    last_mtime = None
    renders = 0
    while True:
        try:
            mtime = os.path.getmtime(args.design)
        except OSError:
            time.sleep(args.poll)
            continue
        if mtime != last_mtime:
            last_mtime = mtime
            try:
                cmd_render(args)
            except KeyboardInterrupt:
                raise
            except Exception as exc:  # a script error is printed; the loop goes on
                print(f"design error: {type(exc).__name__}: {exc}")
            renders += 1
            if args.max_renders and renders >= args.max_renders:
                return
            print(f"watching {args.design} (ctrl-c to stop)")
        time.sleep(args.poll)


def cmd_export(args):
    from .compiler import ExportConfig
    from .evaluator import BatchEvaluator
    from .export.pipeline import export_mesh
    from .observability import ExportMonitor

    scene = load_design(args.design)
    config = scene.export_config
    if args.grid_level is not None:
        config = dataclasses.replace(config or ExportConfig(), grid_level=args.grid_level)
    stl = args.stl or (os.path.splitext(args.design)[0].replace("/", "_") + ".stl")
    monitor = ExportMonitor(out=sys.stdout)
    t0 = time.time()
    mesh, report = export_mesh(
        scene,
        config,
        stl_path=stl,
        ply_path=args.ply,
        evaluator=BatchEvaluator(scene, device=args.device, use_kernels=SDF_FIELDS[args.sdf_field]),
        progress=monitor,
        resume_dir=args.resume_dir,
        strategy=args.strategy,
    )
    print(
        f"exported {report.num_triangles} triangles ({report.num_vertices} vertices) in "
        f"{time.time() - t0:.1f}s (sdf field: {report.stats['sdf_field']})"
    )
    print(f"  strategy: {report.stats['strategy']}; native mesh ops: {report.stats['native']}")
    for stage, secs in report.stage_seconds.items():
        print(f"  {stage:<14s} {secs:7.2f}s")
    histogram = monitor.render_histogram(report.stats)
    if histogram and args.histogram:
        print(histogram)
    print(f"wrote {stl}" + (f" and {args.ply}" if args.ply else ""))


def cmd_preview(args):
    """Screenshot-style render of an exported mesh (STL/PLY) to a PNG
    (export/preview.py; cli.py:260-290 of the JAX package)."""
    from .export.preview import fill_background_pinholes, rasterize_mesh
    from .export.writers import read_ply, read_stl

    path = args.mesh
    mesh = read_ply(path) if path.lower().endswith(".ply") else read_stl(path)
    a, e = np.radians(args.azimuth), np.radians(args.elevation)
    view = np.array([np.sin(a) * np.cos(e), -np.sin(e), np.cos(a) * np.cos(e)])
    img = fill_background_pinholes(rasterize_mesh(mesh, view_dir=view, size=args.size))
    write_png(args.out, img)
    print(f"{args.out}: {mesh.num_faces} triangles at az {args.azimuth} el {args.elevation}")


def cmd_artifacts(args):
    from . import api
    from .designs import design_module

    # Build through the compiler so that its artifacts can be written.
    if args.design.lower() in BUILTIN:
        c = api.new_design()
        design_module(args.design).build(compiler=c)
    else:
        load_design(args.design)
        c = api.current()
    os.makedirs(args.directory, exist_ok=True)
    c.write_artifacts(args.directory)
    print(f"wrote scene.txt / buildprocedure.txt / arbitrary_data.hex to {args.directory}")


def fit_config(width: int, height: int, field: str = "exact"):
    """The render config of ``fit`` (cli.py:230-238 of the JAX package)."""
    from .config import RenderConfig

    return RenderConfig(width=width, height=height, max_steps=128, differentiable=True,
                        soft_silhouette_bandwidth=0.02, gizmo=False, fit_field=field)


def cmd_fit(args):
    """Perturb every object's position but the first and fit the positions
    back to the design's own depth + silhouette render
    (cli.py:222-258 of the JAX package)."""
    import torch

    from .parallel.fit import make_fit_harness, save_checkpoint

    scene = load_design(args.design)
    campos, rgt, upp, fwd = _camera(args).as_arrays()
    harness = make_fit_harness(scene, fit_config(args.width, args.height, args.field),
                               device=args.device)
    target = harness.render_target(scene.arrays, campos, rgt, upp, fwd)

    rng = np.random.default_rng(args.seed)
    start = np.asarray(scene.arrays.position).copy()
    start[1:] += rng.normal(scale=args.perturb, size=start[1:].shape)
    state = harness.init({"position": start})
    truth = torch.as_tensor(scene.arrays.position, device=harness.device)
    print(f"fitting {args.steps} steps on 1 device(s)")
    for i in range(args.steps):
        state, loss = harness.step_fn(state, target, campos, rgt, upp, fwd)
        if (i + 1) % max(1, args.steps // 10) == 0:
            err = float((state.params["position"].detach() - truth).abs().max())
            print(f"step {i+1:4d}  loss {float(loss):.3e}  max pos err {err:.4f}")
    os.makedirs(args.output, exist_ok=True)
    save_checkpoint(os.path.join(args.output, "fit.ckpt"), state)
    print(f"wrote {args.output}/fit.ckpt")


def cmd_studio(args):
    from .studio import serve

    serve(args.workspace, port=args.port, width=args.width, height=args.height,
          device=args.device)


def _unported(name):
    def cmd(args):
        raise SystemExit(
            f"designcsg_tpu_torch: '{name}' is not ported yet (ROADMAP.md {UNPORTED[name]})"
        )

    return cmd


def main(argv=None):
    parser = argparse.ArgumentParser(prog="designcsg_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    def device_arg(p):
        p.add_argument(
            "--device", choices=["cuda", "cpu"], default="cuda",
            help="cuda: the CUDA kernels (default); cpu: the plain PyTorch path",
        )

    p = sub.add_parser("render", help="sphere-trace a design to a PNG")
    p.add_argument("design")
    p.add_argument("-o", "--output", default="render.png")
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--orbit", type=float, nargs=2, metavar=("DA", "DB"))
    p.add_argument("--zoom", type=float, default=0.0)
    p.add_argument("--no-gizmo", action="store_true")
    p.add_argument("--no-default-orbit", action="store_true")
    p.add_argument("--fast", action="store_true",
                   help="over-relaxed + hierarchical cone-prepass march")
    device_arg(p)
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("watch", help="re-render a design script whenever it changes")
    p.add_argument("design")
    p.add_argument("-o", "--output", default="render.png")
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--orbit", type=float, nargs=2, metavar=("DA", "DB"))
    p.add_argument("--zoom", type=float, default=0.0)
    p.add_argument("--no-gizmo", action="store_true")
    p.add_argument("--no-default-orbit", action="store_true")
    p.add_argument("--poll", type=float, default=0.5)
    p.add_argument("--max-renders", type=int, default=0,
                   help="stop after N renders (0 = run until interrupted)")
    device_arg(p)
    p.set_defaults(fn=cmd_watch, fast=False)

    p = sub.add_parser("export", help="mesh-export a design (STL/PLY)")
    p.add_argument("design")
    p.add_argument("--stl")
    p.add_argument("--ply")
    p.add_argument("--grid-level", type=int)
    p.add_argument("--resume-dir")
    p.add_argument("--strategy", choices=["auto", "active", "dense", "compact", "adaptive"],
                   default="auto",
                   help="extraction dataflow; auto follows the design's octree levels "
                   "(adaptive) as the JAX CLI does")
    p.add_argument("--sdf-field", choices=list(SDF_FIELDS), default="auto",
                   help="SDF field the export evaluates: exact tape (reference k2 "
                   "semantics), the kernels' baked twin field, or the evaluator's auto "
                   "choice (exact for approximate-twin scenes such as logo)")
    p.add_argument("--histogram", action="store_true",
                   help="print the per-slab/per-level triangle histogram after export")
    device_arg(p)
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("preview", help="screenshot-style PNG of an exported STL/PLY mesh")
    p.add_argument("mesh", help="path to .stl or .ply")
    p.add_argument("out", nargs="?", default="preview.png")
    p.add_argument("--azimuth", type=float, default=-30.0)
    p.add_argument("--elevation", type=float, default=-15.0)
    p.add_argument("--size", type=int, default=512)
    p.set_defaults(fn=cmd_preview)

    p = sub.add_parser("artifacts", help="emit reference-format IR files")
    p.add_argument("design")
    p.add_argument("-d", "--directory", default=".")
    p.set_defaults(fn=cmd_artifacts)

    p = sub.add_parser("fit", help="differentiable shape-fit demo")
    p.add_argument("design")
    p.add_argument("-o", "--output", default="fit_out")
    p.add_argument("--steps", type=int, default=150)
    p.add_argument("--width", type=int, default=64)
    p.add_argument("--height", type=int, default=48)
    p.add_argument("--perturb", type=float, default=0.3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--orbit", type=float, nargs=2)
    p.add_argument("--zoom", type=float, default=0.0)
    p.add_argument("--field", choices=["exact", "twin"], default="exact",
                   help="SDF field of the gradient reattachment (twin: the field the "
                   "kernels compute, logo's baked letters; the same tape for design1 "
                   "and design2)")
    device_arg(p)
    p.set_defaults(fn=cmd_fit)

    p = sub.add_parser("studio", help="browser-based editor/viewport/export shell")
    p.add_argument("workspace", nargs="?", default="designs_workspace")
    p.add_argument("--port", type=int, default=8642)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    device_arg(p)
    p.set_defaults(fn=cmd_studio)

    for name in UNPORTED:
        p = sub.add_parser(name, help=f"not ported yet (ROADMAP.md {UNPORTED[name]})")
        p.add_argument("rest", nargs=argparse.REMAINDER)
        p.set_defaults(fn=_unported(name))

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
