"""Differentiable shape-parameter fitting (the "training" workload).

Pixel-loss gradients through the sphere-traced render with respect to shape
parameters (designcsg_tpu/parallel/fit.py of the JAX package, BASELINE.json
config 5).  The march runs detached, in the fit's ray-march kernel on the
card, and gradients are reattached at the points it returns
(ops/raymarch.py), so the backward is O(1) in march steps.

One device.  The JAX package's sharded layout (pixels over a mesh,
parameters replicated, gradients ``psum``-ed) is ROADMAP.md queue 1, item 12:
a ``mesh`` raises, and ``use_mesh=True`` is the single-device harness, which
is what a one-device mesh computes.

The harness keeps JAX's functional signatures, ``step_fn(state, target,
campos, rgt, upp, fwd) -> (state, loss)``, but a ``torch.optim`` optimizer
updates in place: the returned state holds the same parameter tensors and
optimizer as the one passed in, updated.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from .. import resolve_device
from ..compiler import CompiledScene, SceneArrays
from ..config import RenderConfig
from ..ops.raymarch import (
    camera_rows,
    make_geometry_renderer,
    make_ray_renderer,
    project,
    ray_directions,
)


class FitState(NamedTuple):
    params: Dict[str, torch.Tensor]  # leaf tensors with requires_grad
    opt_state: torch.optim.Optimizer
    step: int


def adam(lr: float = 1e-2) -> Callable:
    """Optimizer factory ``(params) -> torch.optim.Adam``: optax's
    ``adam(lr)`` hyperparameters (b1 0.9, b2 0.999, eps 1e-8)."""
    return lambda params: torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def default_param_to_arrays(scene: CompiledScene) -> Callable:
    """Default reparameterization: ``params = {"position": f32[N, 3]}``
    swapped into the object banks, which come from the scene on the device
    of the parameters.  For pose-space fitting pass
    :func:`designcsg_tpu_torch.pose.pose_param_to_arrays` instead."""
    bases = {}

    def param_to_arrays(params) -> SceneArrays:
        device = next(iter(params.values())).device
        if device not in bases:
            bases[device] = scene.arrays.to_torch(device)
        return dataclasses.replace(bases[device], **params)

    return param_to_arrays


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _leaf(value, device) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    return torch.tensor(np.asarray(value, np.float32), device=device, requires_grad=True)


@dataclasses.dataclass
class FitHarness:
    """Single-device pixel-loss fit (the JAX package's ``FitHarness``)."""

    scene: CompiledScene
    config: RenderConfig
    #: ``(list of parameter tensors) -> torch.optim.Optimizer``
    optimizer: Callable
    param_to_arrays: Callable
    mesh: Any
    step_fn: Callable
    loss_fn: Callable
    target_fn: Callable
    #: ``multi_step_fn(state, targets, camposes, rgts, upps, fwds) ->
    #: (state, loss)``: one update against the SUM of the loss over a
    #: leading view axis (targets and camera vectors stacked [V, ...]).
    multi_step_fn: Optional[Callable] = None
    device: torch.device = torch.device("cpu")

    def stack_views(self, views):
        """Stack per-view ``(target, campos, rgt, upp, fwd)`` tuples along a
        leading axis for :attr:`multi_step_fn`."""
        first = views[0][0]
        if isinstance(first, tuple):
            targets = tuple(torch.stack([v[0][i] for v in views]) for i in range(len(first)))
        else:
            targets = torch.stack([v[0] for v in views])
        cams = [np.stack([_host(v[i]) for v in views]) for i in range(1, 5)]
        return (self.shard_target(targets),) + tuple(cams)

    def init(self, params) -> FitState:
        params = {k: _leaf(v, self.device) for k, v in params.items()}
        return FitState(params=params, opt_state=self.optimizer(list(params.values())), step=0)

    def render_target(self, arrays, campos, rgt, upp, fwd):
        """Render the fitting target (a (depth, alpha) pair for the geometric
        loss, an RGB image otherwise) from ground-truth banks, without a
        graph.  ``arrays`` may be the scene's numpy banks."""
        if not isinstance(arrays.ad, torch.Tensor):
            arrays = arrays.to_torch(self.device)
        return self.shard_target(self.target_fn(arrays, campos, rgt, upp, fwd))

    def shard_target(self, target):
        """Place a target on the harness's device (one device: nothing to
        shard)."""
        if isinstance(target, tuple):
            return tuple(self.shard_target(t) for t in target)
        return torch.as_tensor(target, device=self.device).detach()


def make_fit_harness(
    scene: CompiledScene,
    config: Optional[RenderConfig] = None,
    optimizer: Optional[Callable] = None,
    param_to_arrays: Optional[Callable] = None,
    mesh=None,
    use_mesh: bool = True,
    loss: str = "geometric",
    silhouette_weight: float = 1.0,
    device=None,
) -> FitHarness:
    """Build the harness on ``device`` (the card unless ``device="cpu"``).

    ``loss="geometric"`` (default) fits depth and soft silhouette, whose
    gradients are correct to first order; ``loss="rgb"`` fits raw pixels
    (shading has crease and material discontinuities that autodiff cannot
    see).  ``optimizer`` is a factory ``(params) -> torch.optim.Optimizer``,
    by default :func:`adam` at 1e-2.  ``mesh`` is not ported (ROADMAP.md
    queue 1, item 12); ``use_mesh`` is accepted and changes nothing on one
    device.  Targets come from :meth:`FitHarness.render_target`."""
    if mesh is not None:
        raise NotImplementedError(
            "make_fit_harness(mesh=...): the sharded fit is not ported yet "
            "(ROADMAP.md queue 1, item 12)"
        )
    if loss not in ("rgb", "geometric"):
        raise ValueError(f"unknown loss {loss!r}")
    device = resolve_device(device)
    if config is None:
        config = RenderConfig(differentiable=True, soft_silhouette_bandwidth=0.02, gizmo=False)
    elif not config.differentiable:
        config = dataclasses.replace(config, differentiable=True)
    optimizer = optimizer or adam(1e-2)
    param_to_arrays = param_to_arrays or default_param_to_arrays(scene)

    render_rays = make_ray_renderer(scene, config)
    render_geom = make_geometry_renderer(scene, config)
    dirs = ray_directions(config, device)

    def frame(campos, rgt, upp, fwd):
        """(o_proj, r_proj, rgt, upp, fwd) on the device, from host vectors."""
        rows = torch.as_tensor(camera_rows(*(_host(a) for a in (campos, rgt, upp, fwd))),
                               device=device)
        return rows[0], project(dirs, *rows[1:]), rows[1], rows[2], rows[3]

    def forward(arrays, campos, rgt, upp, fwd):
        o_proj, r_proj, rgt, upp, fwd = frame(campos, rgt, upp, fwd)
        if loss == "geometric":
            return render_geom(arrays, o_proj, r_proj)
        return render_rays(arrays, o_proj, r_proj, rgt, upp, fwd)

    def loss_fn(params, target, campos, rgt, upp, fwd):
        out = forward(param_to_arrays(params), campos, rgt, upp, fwd)
        if loss == "rgb":
            return torch.mean((out - target) ** 2)
        (d, alpha), (target_d, target_alpha) = out, target
        both = ((d > 0) & (target_d > 0)).to(d.dtype)
        depth_term = torch.sum(both * (d - target_d) ** 2) / torch.clamp(torch.sum(both), min=1.0)
        alpha_term = torch.mean((alpha - target_alpha) ** 2)
        return depth_term + silhouette_weight * alpha_term

    def step_fn(state: FitState, target, campos, rgt, upp, fwd):
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        value = loss_fn(state.params, target, campos, rgt, upp, fwd)
        value.backward()
        opt.step()
        return FitState(state.params, opt, state.step + 1), value.detach()

    def multi_step_fn(state: FitState, targets, camposes, rgts, upps, fwds):
        # Each view's loss is backpropagated on its own and the gradients
        # accumulate (grad distributes over the sum), so only one view's
        # graph is alive at a time.
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        total = torch.zeros((), device=device)
        for v in range(len(camposes)):
            target = tuple(t[v] for t in targets) if isinstance(targets, tuple) else targets[v]
            value = loss_fn(state.params, target, camposes[v], rgts[v], upps[v], fwds[v])
            value.backward()
            total = total + value.detach()
        opt.step()
        return FitState(state.params, opt, state.step + 1), total

    def target_fn(arrays, campos, rgt, upp, fwd):
        with torch.no_grad():
            return forward(arrays.detach(), campos, rgt, upp, fwd)

    return FitHarness(
        scene=scene,
        config=config,
        optimizer=optimizer,
        param_to_arrays=param_to_arrays,
        mesh=None,
        step_fn=step_fn,
        loss_fn=loss_fn,
        target_fn=target_fn,
        multi_step_fn=multi_step_fn,
        device=device,
    )


def fit_state_from_numpy(
    params: dict, mu: dict, nu: dict, count: int, device=None, optimizer: Optional[Callable] = None
) -> FitState:
    """A fit state of the JAX package as the port's :class:`FitState`:
    ``params`` and Adam's moments ``mu`` and ``nu`` (optax's
    ``ScaleByAdamState`` leaves) as numpy arrays keyed as the parameters,
    and its step ``count``, which becomes both the harness's step and
    Adam's.  ``optimizer`` is an Adam factory, :func:`adam` at 1e-2 by
    default."""
    device = resolve_device(device)
    leaves = {k: _leaf(v, device) for k, v in params.items()}
    opt = (optimizer or adam(1e-2))(list(leaves.values()))
    for k, p in leaves.items():
        opt.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": torch.tensor(np.asarray(mu[k], np.float32), device=device),
            "exp_avg_sq": torch.tensor(np.asarray(nu[k], np.float32), device=device),
        }
    return FitState(leaves, opt, int(count))


def save_checkpoint(path: str, state: FitState) -> None:
    """Write the parameters, the optimizer's state and the step with
    ``torch.save``."""
    torch.save(
        {
            "params": {k: v.detach().cpu() for k, v in state.params.items()},
            "opt_state": state.opt_state.state_dict(),
            "step": int(state.step),
        },
        path,
    )


def load_checkpoint(path: str, optimizer: Optional[Callable] = None, device=None) -> FitState:
    """Read a :func:`save_checkpoint` file back into a :class:`FitState` on
    ``device``, the optimizer rebuilt by ``optimizer`` (:func:`adam` by
    default; its hyperparameters come from the file)."""
    device = resolve_device(device)
    data = torch.load(path, map_location=device, weights_only=True)
    params = {k: v.to(device).requires_grad_() for k, v in data["params"].items()}
    opt = (optimizer or adam(1e-2))(list(params.values()))
    opt.load_state_dict(data["opt_state"])
    return FitState(params, opt, data["step"])
