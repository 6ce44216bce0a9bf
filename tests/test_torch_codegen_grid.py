"""Host build of the grid kernel's column form (K3) and of the cone prepass
split across a block's warps (K5), the two kernels redesigned for Hopper.

The grid kernel owns one lattice column a thread: it makes the z-invariant
part of each object's frame transform once (``column_terms``) and finishes
each point from it (``field_sdf_column``); its culled form runs K7's lane
chain on the tile's box and the column form of the culled field
(csrc/sdf_kernels.cu).  The cone kernel deals the tape's slots among S warps
of a block of 32 rays, joins them in shared memory and runs the tape's rows
in every warp (csrc/cone_kernel.cu).  The host harness (csrc/host_harness.cpp)
runs the same generated functions in plain loops, the warps emulated as
loops and the barrier as the end of one; here each is held bit for bit
against the point form, the unculled grid, ``cull_tile``'s predicates and
one thread's cone march.  Built with g++ as tests/test_torch_codegen.py
builds its units.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from designcsg_tpu_torch.config import RenderConfig
from designcsg_tpu_torch.constants import MAX_OBJECTS
from designcsg_tpu_torch.camera import Camera
from designcsg_tpu_torch.designs import get_design
from designcsg_tpu_torch.ops import cull
from designcsg_tpu_torch.ops.cuda.build import csrc
from designcsg_tpu_torch.ops.cuda.sdf_kernel import lattice_points, make_grid_eval
from designcsg_tpu_torch.ops.cuda.tape import (
    COLUMN_HOIST_MAX,
    CONE_WARP_CHOICES,
    CONE_WARPS,
    GRID_CULL_COLUMN_MIN_HOISTED,
    _imports,
    column_frame_ops,
    column_hoisted,
    cone_deal,
    cone_kernel_source,
    cone_shared_bytes,
    cone_slot_costs,
    cone_split_function,
    cone_warps,
    grid_cull_column,
    grid_cull_lanes,
    scene_source,
    sdf_kernel_source,
)
from designcsg_tpu_torch.ops.raymarch import camera_rows, coarse_ray_uv, make_cone_march, project
from torch_scenes import custom_brush_scene, many_groups_scene


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread per test process: the suite runs one process per
    worker, and a default-sized thread pool in each oversubscribes the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
DESIGNS = ("design1", "design2", "logo")
# The hierarchical viewport at 80x60: 16x12 block-centre rays, six blocks
# of 32 for the split cone.
FAST = RenderConfig(width=80, height=60, max_steps=96, march_overrelax=1.6,
                    march_hierarchical=True)
# A slab of the lattice at 7/48 over the designs' box: tiles of 32x8x8
# cut ragged on every axis.
GRID = (np.full(3, -3.5, np.float32), np.float32(7.0 / 48), 4.0, 19, 33, 70)


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """{(scene, kind): ctypes library}: the point/grid unit without ("sdf")
    and with the gizmo ("sdf_gizmo") per design and without for the
    89-group scene; the cone unit ("cone": the renderer's scene code and
    every split of the cone) per design."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler (g++) to build the generated source")
    scenes = {name: get_design(name) for name in DESIGNS}
    scenes["many"] = many_groups_scene()
    builds = {("many", "sdf"): scene_source(scenes["many"], cull=1)}
    for name in DESIGNS:
        scene = scenes[name]
        builds[(name, "sdf")] = scene_source(scene, cull=1)
        builds[(name, "sdf_gizmo")] = scene_source(scene, cull=1, gizmo=True)
        builds[(name, "cone")] = ("#define HOST_RENDER\n" + scene_source(scene, FAST) + "\n"
                                  + cone_split_function(scene, FAST.gizmo, CONE_WARP_CHOICES))
    out = tmp_path_factory.mktemp("host_build_grid")
    running = {}
    for (name, kind), text in builds.items():
        src = out / f"{name}_{kind}.cpp"
        src.write_text(text + "\n" + csrc("host_harness.cpp"))
        so = out / f"{name}_{kind}.so"
        cmd = [gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-o", str(so), str(src)]
        running[(name, kind)] = (subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True), so)
    libs = {}
    for key, (proc, so) in running.items():
        _, err = proc.communicate()
        assert proc.returncode == 0, err
        lib = ctypes.CDLL(str(so))
        if key[1] == "cone":
            lib.host_cone_march.argtypes = [_P, ctypes.c_longlong, _P, _P, _P, _P, _P]
            lib.host_cone_march_split.argtypes = [_I, _P, ctypes.c_longlong, _P, _P, _P, _P, _P]
        else:
            lib.host_point_eval.argtypes = [_P, _P, ctypes.c_longlong, _P, _P, _P]
            grid_args = [_P, _I, _I, _I] + [_F] * 5 + [_P] * 3
            lib.host_grid_eval.argtypes = grid_args
            lib.host_grid_eval_cull.argtypes = grid_args
            lib.host_grid_eval_cull_point.argtypes = grid_args
            lib.host_grid_tile_cull.argtypes = [_I] * 6 + [_F] * 5 + [_I] + [_P] * 5
        libs[key] = lib
    return scenes, libs


def _bank(arrays):
    """The interleaved per-object bank the kernels read."""
    return np.ascontiguousarray(
        np.concatenate([arrays.position, arrays.right, arrays.up, arrays.forward], axis=1),
        np.float32,
    )


def _extras(scene):
    flat, _ = scene.device_extras("cpu")
    return None if flat is None else flat.numpy()


def _ptr(a):
    return None if a is None else a.ctypes.data


def _scene_args(scene):
    bank, ex = _bank(scene.arrays), _extras(scene)
    return (bank, ex), (bank.ctypes.data, scene.arrays.ad.ctypes.data, _ptr(ex))


def _grid(lib, fn, scene, lo, cell, z0, nz, ny, nx):
    out = np.empty((nz, ny, nx), np.float32)
    keep, args = _scene_args(scene)
    getattr(lib, fn)(out.ctypes.data, nz, ny, nx, *(float(v) for v in lo), float(cell), float(z0),
                     *args)
    return out


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("gizmo", [False, True])
@pytest.mark.parametrize("name", DESIGNS)
def test_column_grid_bit_equal_to_point_form(host_libs, name, gizmo):
    """The grid kernel's column form (frame terms once a column, 7 FP32
    operations an object a point) gives the point form's bits at every
    lattice point, on each design's k2 field and its k1 field (with the
    gizmo), and its plain version's values by the grid rule."""
    scenes, libs = host_libs
    scene, lib = scenes[name], libs[(name, "sdf_gizmo" if gizmo else "sdf")]
    lo, cell, z0, nz, ny, nx = GRID
    got = _grid(lib, "host_grid_eval", scene, *GRID)
    pts = np.ascontiguousarray(lattice_points(lo, cell, z0, nz, ny, nx, "cpu").reshape(-1, 3).numpy())
    point = np.empty(len(pts), np.float32)
    keep, args = _scene_args(scene)
    lib.host_point_eval(pts.ctypes.data, point.ctypes.data, len(pts), *args)
    np.testing.assert_array_equal(_bits(got).reshape(-1), _bits(point))
    plain = make_grid_eval(scene, gizmo=gizmo).plain(scene.arrays.to_torch("cpu"), *GRID).numpy()
    assert (np.abs(got - plain) <= 1e-5 + 1e-6 * np.abs(plain)).all()
    assert (got < 0).any() and (got > 0).any()


def _tile_chains(lib, scene, plan, grid):
    """Per tile of the culled grid: (words, substitutes) of the lane chain
    and of cull_tile on the tile's box."""
    lo, cell, z0, nz, ny, nx = grid
    words = max(1, -(-len(plan.groups) // 32))
    keep, args = _scene_args(scene)
    out = {0: [], 1: []}
    for zb in range(0, nz, 8):
        for y0 in range(0, ny, 8):
            for x0 in range(0, nx, 32):
                for lanes in (0, 1):
                    preds = np.zeros(words, np.uint32)
                    substs = np.zeros(plan.n_slots, np.float32)
                    lib.host_grid_tile_cull(x0, y0, zb, nz, ny, nx, *(float(v) for v in lo),
                                            float(cell), float(z0), lanes, *args,
                                            preds.ctypes.data, substs.ctypes.data)
                    out[lanes].append((preds, substs))
    return out


@pytest.mark.parametrize("gizmo", [False, True])
@pytest.mark.parametrize("name", DESIGNS)
def test_culled_column_grid_on_lane_chain(host_libs, name, gizmo):
    """The culled grid as the kernel now runs it (the lane chain on each
    tile's box, its 32 lanes emulated and its shuffles read from the lanes'
    array, then the culled field's column form, or its point form where
    ``GRID_CULL_COLUMN`` is 0) equals the unculled column grid bit for bit,
    and each tile's lane chain gives ``cull_tile``'s predicate words and
    substitutes bit for bit."""
    scenes, libs = host_libs
    scene, lib = scenes[name], libs[(name, "sdf_gizmo" if gizmo else "sdf")]
    got = _grid(lib, "host_grid_eval_cull", scene, *GRID)
    np.testing.assert_array_equal(_bits(got), _bits(_grid(lib, "host_grid_eval", scene, *GRID)))
    point = _grid(lib, "host_grid_eval_cull_point", scene, *GRID)
    np.testing.assert_array_equal(_bits(point), _bits(got))
    plan = cull.make_cull_plan(scene, gizmo)
    chains = _tile_chains(lib, scene, plan, GRID)
    assert len(chains[1]) == 3 * 5 * 3
    for (p_tile, s_tile), (p_lanes, s_lanes) in zip(chains[0], chains[1]):
        np.testing.assert_array_equal(p_lanes, p_tile)
        np.testing.assert_array_equal(_bits(s_lanes), _bits(s_tile))
    groups = np.arange(len(plan.groups))
    bits = np.stack([(p[groups // 32] >> (groups % 32).astype(np.uint32)) & 1 for p, _ in chains[1]])
    assert (bits == 0).any() or name == "design2"


def test_culled_column_grid_many_groups(host_libs):
    """89 cull groups (three predicate words, 133 imports of which the column
    form hoists COLUMN_HOIST_MAX): the culled column grid equals the
    unculled column grid and the point form bit for bit, and the tiles' lane
    chains give cull_tile's predicates, with groups past the first word
    kept."""
    scenes, libs = host_libs
    scene, lib = scenes["many"], libs[("many", "sdf")]
    plan = cull.make_cull_plan(scene, False)
    assert len(plan.groups) == 89 and len(column_hoisted(scene)) == COLUMN_HOIST_MAX
    grid = (np.array([-6.0, -2.5, -1.0], np.float32), np.float32(0.125), 4.0, 9, 40, 96)
    got = _grid(lib, "host_grid_eval_cull", scene, *grid)
    unculled = _grid(lib, "host_grid_eval", scene, *grid)
    np.testing.assert_array_equal(_bits(got), _bits(unculled))
    np.testing.assert_array_equal(_bits(_grid(lib, "host_grid_eval_cull_point", scene, *grid)),
                                  _bits(unculled))
    pts = np.ascontiguousarray(lattice_points(*grid, "cpu").reshape(-1, 3).numpy())
    point = np.empty(len(pts), np.float32)
    keep, args = _scene_args(scene)
    lib.host_point_eval(pts.ctypes.data, point.ctypes.data, len(pts), *args)
    np.testing.assert_array_equal(_bits(unculled).reshape(-1), _bits(point))
    assert (got < 0).any()
    chains = _tile_chains(lib, scene, plan, grid)
    for (p_tile, s_tile), (p_lanes, s_lanes) in zip(chains[0], chains[1]):
        np.testing.assert_array_equal(p_lanes, p_tile)
        np.testing.assert_array_equal(_bits(s_lanes), _bits(s_tile))
    words = np.stack([p for p, _ in chains[1]])
    groups = np.arange(89)
    bits = (words[:, groups // 32] >> (groups % 32).astype(np.uint32)) & 1
    assert bits[:, 32:].any() and not bits.all()


def _coarse(scene):
    rows = camera_rows(*Camera.initial().orbit(0.3, -0.2).as_arrays())
    rays = project(torch.from_numpy(coarse_ray_uv(FAST)), *torch.from_numpy(rows[1:]))
    return np.ascontiguousarray(rows[0]), np.ascontiguousarray(rays.reshape(-1, 3).numpy())


@pytest.mark.parametrize("warps", CONE_WARP_CHOICES)
@pytest.mark.parametrize("name", DESIGNS)
def test_cone_split_bit_equal_to_cone_ray(host_libs, name, warps):
    """The cone march split across S warps (each warp its dealt slots for
    the block's 32 rays, the barrier between, the tape's rows in every warp)
    gives one thread's ``cone_ray`` t_safe bit for bit, every warp's copy of
    the rays agreeing at every step; and the plain version's handoffs."""
    scenes, libs = host_libs
    scene, lib = scenes[name], libs[(name, "cone")]
    o, rays = _coarse(scene)
    n = len(rays)
    assert n % 32 == 0
    keep, args = _scene_args(scene)
    one = np.empty(n, np.float32)
    lib.host_cone_march(one.ctypes.data, n, rays.ctypes.data, o.ctypes.data, *args)
    split = np.empty(n, np.float32)
    assert lib.host_cone_march_split(warps, split.ctypes.data, n, rays.ctypes.data, o.ctypes.data,
                                     *args) == 0
    np.testing.assert_array_equal(_bits(split), _bits(one))
    # A batch that leaves the last block part empty.
    part = np.empty(n - 5, np.float32)
    assert lib.host_cone_march_split(warps, part.ctypes.data, n - 5, rays.ctypes.data,
                                     o.ctypes.data, *args) == 0
    np.testing.assert_array_equal(_bits(part), _bits(one[: n - 5]))
    ref = make_cone_march(scene, FAST)(scene.arrays.to_torch("cpu"), o, torch.from_numpy(rays)).numpy()
    far = FAST.max_distance
    assert ((split > far) == (ref > far)).mean() >= 0.99
    assert (split > 0).any() and (split < far).any()


def test_column_form_counts_and_hoist_rule():
    """Counted from the generated code: the column form hoists every import
    whose brush reads its coordinates (Design1 10 of 11, Design2 2 of 3,
    Logo 3 of 5; the empty slots' transform the compiler drops), and its
    frame work a point falls from 18 to 7 FP32 operations an object, 11 a
    column; the grid unit carries the column form, a renderer's does not."""
    want = {"design1": (10, 180, 70, 110), "design2": (2, 36, 14, 22), "logo": (3, 54, 21, 33)}
    for name, (hoisted, point, column, per_column) in want.items():
        scene = get_design(name)
        ops = column_frame_ops(scene)
        assert (ops["hoisted"], ops["point_form"], ops["column_form"], ops["per_column"]) == (
            hoisted, point, column, per_column)
        assert column_frame_ops(scene, gizmo=True) == ops
        src = sdf_kernel_source(scene, cull=True)
        assert "HD float field_sdf_column(" in src and "HD float field_sdf_culled_column(" in src
        assert "field_sdf_column(" not in scene_source(scene, FAST)
    many = column_frame_ops(many_groups_scene())
    assert many["hoisted"] == COLUMN_HOIST_MAX
    assert many["column_form"] == many["point_form"] - 11 * COLUMN_HOIST_MAX


def test_cone_deal_and_warps_rule():
    """Every slot goes to one warp, the costliest first to the least loaded
    (Logo's three letters on three warps of four); the kernel splits each
    design's field across four warps, a field of fewer slots than warps
    too (its idle warps get empty deals); the kernel's source carries the
    choice and only the cone_slots it runs."""
    for name in DESIGNS:
        scene = get_design(name)
        costs = cone_slot_costs(scene, True)
        for warps in CONE_WARP_CHOICES:
            deal = cone_deal(scene, True, warps)
            assert sorted(k for d in deal for k in d) == list(range(len(costs)))
        assert cone_warps(scene, True) == 4
        src = cone_kernel_source(scene, FAST)
        assert "#define CONE_WARPS 4" in src
        assert re.findall(r"template <> HD void cone_slots<(\d+)>", src) == ["4"]
    logo = get_design("logo")
    assert sorted(len(d) for d in cone_deal(logo, True, 4)[:3]) == [1, 1, 1]
    few = custom_brush_scene()
    assert len(cone_slot_costs(few, False)) < 4 and cone_warps(few, False) == 4
    assert [] in cone_deal(few, False, 4)
    lever = cone_kernel_source(get_design("design2"), FAST, warps=8)
    assert "#define CONE_WARPS 8" in lever
    assert re.findall(r"template <> HD void cone_slots<(\d+)>", lever) == ["8"]


@pytest.mark.parametrize("n, warps", [(44, 4), (52, 4), (54, 0), (66, 0), (170, 0)])
def test_cone_warps_fit_shared_memory(n, warps):
    """The split cone's shared memory (the bank's 48 B an object and two
    buffers of 32 values a slot: 256 B) stays within the 48 KB a kernel may
    declare: a scene past it (from 161 objects, with the gizmo's slot) keeps
    one thread a ray, whose bank alone fits the compiler's MAX_OBJECTS; the
    89-group scene (133 objects) splits."""
    scene = many_groups_scene(n)
    assert cone_warps(scene, True) == warps
    split = cone_shared_bytes(scene, True, CONE_WARPS)
    assert split == 4 * (12 * scene.num_objects + 64 * (len(_imports(scene)) + 1))
    assert (split <= 48 * 1024) == (warps == CONE_WARPS)
    assert cone_shared_bytes(scene, True, 0) == 48 * scene.num_objects
    assert 48 * MAX_OBJECTS <= 48 * 1024
    src = cone_kernel_source(scene, FAST)
    assert f"#define CONE_WARPS {warps}\n" in src
    assert ("template <> HD void cone_slots<" in src) == bool(warps)


def test_grid_cull_chain_rule():
    """The culled grid runs its tile's chain on the first warp's lanes where
    that cuts the chain's FP32 operations to at most 0.8 of one thread's
    (Design1 and Design2, with and without the gizmo; the 89-group scene),
    and in one thread where the lanes' passes, one per brush kind, add up
    to nearly the whole chain (Logo's letters); the unit's source carries
    the choice."""
    for name, want in (("design1", True), ("design2", True), ("logo", False)):
        scene = get_design(name)
        for gizmo in (False, True):
            assert grid_cull_lanes(scene, gizmo) is want
            assert f"#define GRID_CULL_LANES {int(want)}" in sdf_kernel_source(scene, gizmo=gizmo,
                                                                              cull=True)
    assert grid_cull_lanes(many_groups_scene(), False)


def test_grid_cull_column_rule():
    """The culled grid's z loop runs the column form where it hoists at
    least three imports' frame terms (Design1 10, Logo 3, the 89-group
    scene 16) and the point form on Design2 (2), with and without the
    gizmo; the unit's source carries the choice and both forms' code."""
    for scene, want in ((get_design("design1"), True), (get_design("design2"), False),
                        (get_design("logo"), True), (many_groups_scene(), True)):
        assert (len(column_hoisted(scene)) >= GRID_CULL_COLUMN_MIN_HOISTED) is want
        for gizmo in (False, True):
            assert grid_cull_column(scene, gizmo) is want
            src = sdf_kernel_source(scene, gizmo=gizmo, cull=True)
            assert f"#define GRID_CULL_COLUMN {int(want)}" in src
            assert "HD float field_sdf_culled(" in src and "HD float field_sdf_culled_column(" in src
