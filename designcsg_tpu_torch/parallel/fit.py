"""Differentiable shape-parameter fitting (the "training" workload).

Pixel-loss gradients through the sphere-traced render with respect to shape
parameters (designcsg_tpu/parallel/fit.py of the JAX package, BASELINE.json
config 5).  The march runs detached, in the fit's ray-march kernel on the
card, and gradients are reattached at the points it returns
(ops/raymarch.py), so the backward is O(1) in march steps.

With a ``mesh`` (parallel/mesh.py) the JAX package's sharded layout
(fit.py:182-258 there): each rank marches its own block of pixel rows (the
ray-march kernel on the card) with a rank-local early exit, and no
collective runs inside the march (fit.py:202-209 there says why).  The
collectives run on the loss terms and the gradients only.  The geometric
loss is ``sum(num_k) / max(sum(den_k), 1) + w * sum(asq_k) / n_pixels`` over
the ranks k, where ``den`` counts the pixels both frames hit, which carries
no gradient: so ``den`` is all-reduced first, each rank back-propagates its
own ``num_k / den + w * asq_k / n_pixels``, and the gradients are
all-reduced with SUM, which is the gradient of the global loss (the mean of
the per-rank ratios' gradients would not be).  Parameters and the Adam
state stay replicated and identical on every rank: each applies the same
reduced gradient.

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
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

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


class _SumOverRanks(torch.autograd.Function):
    """The sum of a rank's loss share over the world's ranks; the backward
    passes the gradient to the rank's own share unchanged, and the harness
    all-reduces the parameters' gradients afterwards (:func:`_reduce_grads`)."""

    @staticmethod
    def forward(ctx, value):
        total = value.detach().clone()
        dist.all_reduce(total)
        return total

    @staticmethod
    def backward(ctx, grad):
        return grad


def _reduce_grads(params) -> None:
    """All-reduce (SUM) every parameter's gradient over the world's ranks;
    a rank whose share gave a parameter no gradient contributes zeros."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        dist.all_reduce(p.grad)


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
    """Pixel-loss fit (the JAX package's ``FitHarness``), on one device or,
    with a ``mesh``, with pixel rows sharded over its ranks."""

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
    #: The frame rows ``(row0, row1)`` this rank renders: all of them
    #: without a mesh.
    rows: Optional[tuple] = None

    def stack_views(self, views):
        """Stack per-view ``(target, campos, rgt, upp, fwd)`` tuples along a
        leading axis for :attr:`multi_step_fn` (each target's rows placed
        by :meth:`shard_target`)."""
        first = views[0][0]
        if isinstance(first, tuple):
            targets = tuple(torch.stack([torch.as_tensor(v[0][i]) for v in views])
                            for i in range(len(first)))
        else:
            targets = torch.stack([torch.as_tensor(v[0]) for v in views])
        cams = [np.stack([_host(v[i]) for v in views]) for i in range(1, 5)]
        return (self.shard_target(targets, axis=1),) + tuple(cams)

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

    def shard_target(self, target, axis: int = 0):
        """Place a target on the harness's device: with a mesh, the rank's
        rows of a whole frame (rows along ``axis``; a target that already
        holds only the rank's rows stays as it is)."""
        if isinstance(target, tuple):
            return tuple(self.shard_target(t, axis) for t in target)
        target = torch.as_tensor(target, device=self.device).detach()
        if self.mesh is None or target.shape[axis] == self.rows[1] - self.rows[0]:
            return target
        if target.shape[axis] != self.config.height:
            raise ValueError(f"a target of {target.shape[axis]} rows on axis {axis}: the frame "
                             f"has {self.config.height}, this rank renders "
                             f"{self.rows[1] - self.rows[0]}")
        return target.narrow(axis, self.rows[0], self.rows[1] - self.rows[0])


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
    by default :func:`adam` at 1e-2.  Targets come from
    :meth:`FitHarness.render_target`.

    ``mesh`` (a :class:`~torch.distributed.device_mesh.DeviceMesh` of
    parallel/mesh.py) shards the pixel rows over its ranks, all axes
    jointly, in blocks of ``ceil(H / n)`` rows (the last may be shorter),
    on the rank's device (``device`` is then ignored); ``loss_fn`` returns
    the global loss on every rank, and the steps all-reduce the gradients.
    ``use_mesh`` is accepted for the JAX package's signature; without a
    mesh it changes nothing."""
    if mesh is not None and not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh (parallel/mesh.py "
                        f"make_mesh), got {type(mesh).__name__}")
    if loss not in ("rgb", "geometric"):
        raise ValueError(f"unknown loss {loss!r}")
    if mesh is not None:
        from .mesh import mesh_device, mesh_rank

        device = mesh_device(mesh)
    device = resolve_device(device)
    if config is None:
        config = RenderConfig(differentiable=True, soft_silhouette_bandwidth=0.02, gizmo=False)
    elif not config.differentiable:
        config = dataclasses.replace(config, differentiable=True)
    optimizer = optimizer or adam(1e-2)
    param_to_arrays = param_to_arrays or default_param_to_arrays(scene)

    render_rays = make_ray_renderer(scene, config)
    render_geom = make_geometry_renderer(scene, config)
    rows = (0, config.height)
    if mesh is not None:
        k, n = mesh_rank(mesh)
        per = -(-config.height // n)
        rows = (min(k * per, config.height), min((k + 1) * per, config.height))
    dirs = ray_directions(config, device)[rows[0] : rows[1]]
    n_pixels = float(config.width * config.height)

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
        if mesh is not None:
            return _SumOverRanks.apply(sharded_share(out, target))
        if loss == "rgb":
            return torch.mean((out - target) ** 2)
        (d, alpha), (target_d, target_alpha) = out, target
        both = ((d > 0) & (target_d > 0)).to(d.dtype)
        depth_term = torch.sum(both * (d - target_d) ** 2) / torch.clamp(torch.sum(both), min=1.0)
        alpha_term = torch.mean((alpha - target_alpha) ** 2)
        return depth_term + silhouette_weight * alpha_term

    def sharded_share(out, target):
        """This rank's share of the global loss (fit.py:216-235 of the JAX
        package), the pixel count ``den`` reduced over the ranks first."""
        if loss == "rgb":
            return torch.sum((out - target) ** 2) / (n_pixels * 3.0)
        (d, alpha), (target_d, target_alpha) = out, target
        both = ((d > 0) & (target_d > 0)).to(d.dtype)
        den = torch.sum(both).detach().clone()
        dist.all_reduce(den)
        num = torch.sum(both * (d - target_d) ** 2)
        asq = torch.sum((alpha - target_alpha) ** 2)
        return num / torch.clamp(den, min=1.0) + silhouette_weight * asq / n_pixels

    def backward(value) -> None:
        """Back-propagate a loss: with a mesh, the rank's share (a rank whose
        rows give it no graph has none; :meth:`reduce` then sums)."""
        if mesh is None or value.requires_grad:
            value.backward()

    def reduce(params) -> None:
        if mesh is not None:
            _reduce_grads(params)

    def step_fn(state: FitState, target, campos, rgt, upp, fwd):
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        value = loss_fn(state.params, target, campos, rgt, upp, fwd)
        backward(value)
        reduce(state.params.values())
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
            backward(value)
            total = total + value.detach()
        reduce(state.params.values())
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
        mesh=mesh,
        step_fn=step_fn,
        loss_fn=loss_fn,
        target_fn=target_fn,
        multi_step_fn=multi_step_fn,
        device=device,
        rows=rows,
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
