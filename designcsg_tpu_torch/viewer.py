"""The viewport outside the studio (viewer.py of the JAX package).

The reference's wxWidgets draw pane renders on idle events and orbits with
mouse drags (DrawPane.cpp).  Library equivalents:

* :func:`orbit_frames` / :func:`orbit_animation`: a camera orbit rendered to
  frames or to an animated GIF (headless);
* :func:`interactive`: a matplotlib window with drag-to-orbit and
  scroll-to-zoom on the reference's camera handlers (needs a display, or
  matplotlib's Agg backend and synthetic events).

Every frame goes through :func:`~designcsg_tpu_torch.ops.raymarch.make_scene_renderer`:
the CUDA renderer on the card for a scene with CUDA bodies, the plain route
otherwise (a proxy scene such as Logo through the compacted renderer).
matplotlib and Pillow are imported only by the functions that need them.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from . import resolve_device
from .camera import Camera
from .compiler import CompiledScene
from .config import RenderConfig
from .observability import span, to_host


def _make_render_fn(scene: CompiledScene, config: RenderConfig, device=None):
    """``run(camera) -> f32[H, W, 3]`` (numpy) on ``device`` (default
    ``cuda``); ``run.engine`` names the renderer's route.  The renderer
    and the scene's banks are built and uploaded once.  A frame is a
    ``viewer.frame`` span: ``viewer.render`` from the camera to the
    renderer's launch, then the read-back's ``copy.d2h``."""
    from .ops.raymarch import make_scene_renderer

    device = resolve_device(device)
    arrays = scene.arrays.to_torch(device)
    render = make_scene_renderer(scene, config, device)

    def run(camera: Camera) -> np.ndarray:
        with span("viewer.frame"):
            with span("viewer.render"):
                image = render(arrays, *camera.as_arrays())
            return to_host(image)

    run.engine = render.engine
    return run


def _require(module: str, package: str, what: str):
    try:
        return __import__(module, fromlist=["_"])
    except ImportError as exc:
        raise ImportError(f"{what} needs {package} (pip install {package.lower()})") from exc


def orbit_frames(
    scene: CompiledScene,
    n_frames: int = 24,
    config: Optional[RenderConfig] = None,
    device=None,
    da_total: float = 2 * np.pi,
    db: float = 0.0,
) -> List[np.ndarray]:
    """``n_frames`` frames of an orbit by ``da_total`` around the scene
    (f32[H, W, 3] each), from the default camera."""
    run = _make_render_fn(scene, config or RenderConfig(), device)
    cam = Camera.initial()
    frames = []
    for _ in range(n_frames):
        frames.append(run(cam))
        cam.orbit(da_total / n_frames, db)
    return frames


def orbit_animation(
    scene: CompiledScene,
    path: str,
    n_frames: int = 24,
    config: Optional[RenderConfig] = None,
    device=None,
    fps: int = 12,
) -> str:
    """Write an orbiting GIF of the scene (needs Pillow)."""
    image = _require("PIL.Image", "Pillow", "orbit_animation")
    from .ops.raymarch import to_u8

    frames = orbit_frames(scene, n_frames, config, device)
    images = [image.fromarray(to_u8(torch.from_numpy(f)).numpy()) for f in frames]
    images[0].save(path, save_all=True, append_images=images[1:], duration=int(1000 / fps), loop=0)
    return path


class ViewerSession:
    """What :func:`interactive` returns: the figure, its image, the camera
    and the event handlers, so the viewer can be driven without a display."""

    def __init__(self, fig, image, camera, handlers):
        self.fig, self.image, self.camera = fig, image, camera
        self.on_press, self.on_release, self.on_move, self.on_scroll = handlers


def interactive(
    scene: CompiledScene,
    config: Optional[RenderConfig] = None,
    device=None,
    show: bool = True,
) -> ViewerSession:
    """Drag to orbit, scroll to zoom: the draw pane's mouse handlers
    (DrawPane.cpp:561-584) on a matplotlib canvas (needs matplotlib).
    ``show=False`` with the Agg backend and synthetic events drives it
    headless."""
    plt = _require("matplotlib.pyplot", "matplotlib", "interactive")
    config = config or RenderConfig(width=320, height=240, max_steps=128)
    run = _make_render_fn(scene, config, device)
    cam = Camera.initial()

    fig, ax = plt.subplots()
    im = ax.imshow(np.clip(run(cam), 0, 1))
    ax.set_axis_off()
    state = {"drag": None}

    def redraw():
        im.set_data(np.clip(run(cam), 0, 1))
        fig.canvas.draw_idle()

    def on_press(event):
        state["drag"] = (event.x, event.y)

    def on_release(event):
        state["drag"] = None

    def on_move(event):
        if state["drag"] is None:
            return
        px, py = state["drag"]
        cam.orbit(-(px - event.x) / 15.0 * (np.pi / 30.0), (py - event.y) / 15.0 * (np.pi / 30.0))
        state["drag"] = (event.x, event.y)
        redraw()

    def on_scroll(event):
        cam.zoom(event.step)
        redraw()

    for name, handler in (("button_press_event", on_press), ("button_release_event", on_release),
                          ("motion_notify_event", on_move), ("scroll_event", on_scroll)):
        fig.canvas.mpl_connect(name, handler)
    if show:  # pragma: no cover - needs a display
        plt.show()
    return ViewerSession(fig, im, cam, (on_press, on_release, on_move, on_scroll))
