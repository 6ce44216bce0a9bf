"""Host build of K7's lane chain, the warp-parallel form of the interval cull
that the culled renderer (K2) runs in its dynamic mode.

On the card one lane of the warp runs one slot of the cull plan
(``cull_lane``: its object's frame interval, then one pass per brush kind),
shuffles gather the slots' intervals into every lane and the relevance tree
(``cull_tree``) runs warp-uniform (csrc/march.cuh cull_tile_lanes).  The host
harness (csrc/host_harness.cpp) runs the same generated functions for the
32 lanes in turn and reads the lanes' array where the card shuffles.  Here
its predicates and substitutes are held bit for bit against the one-thread
chain ``cull_tile`` (K3's and the hoisted chain's, unchanged) and against
the plain culler, and the host culled renderer against the unculled host
render.  Built with g++ as tests/test_torch_codegen.py builds its units.
"""

import ctypes
import dataclasses
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch

from designcsg_tpu_torch.camera import Camera
from designcsg_tpu_torch.config import RenderConfig
from designcsg_tpu_torch.designs import get_design
from designcsg_tpu_torch.ops import cull
from designcsg_tpu_torch.ops.cuda.build import csrc, stream_handle
from designcsg_tpu_torch.ops.cuda.march_kernel import make_cuda_ray_march, make_cuda_renderer
from designcsg_tpu_torch.ops.cuda.tape import (
    BANK_CONSTANT_MAX_OBJECTS,
    cull_chain_ops,
    cull_lane_function,
    lane_chain_ops,
    march_kernel_source,
    ray_march_kernel_source,
    scene_source,
    sdf_kernel_source,
)
from designcsg_tpu_torch.ops.interpreter import eval_context
from designcsg_tpu_torch.ops.raymarch import camera_rows, make_renderer
from torch_scenes import many_groups_scene


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread per test process: the suite runs one process per
    worker, and a default-sized thread pool in each oversubscribes the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_P = ctypes.c_void_p
HOST_RENDER = "#define HOST_RENDER\n"
# The culled renderers at 64x48 (16x2 warp tiles, 4 by 24 of them); the
# renderer's field carries the gizmo, so its plan has the gizmo's slot.
CULL = RenderConfig(width=64, height=48, max_steps=80, march_cull=True)
CULL_DYNAMIC = dataclasses.replace(CULL, march_cull="dynamic")
# Logo close up and head on with a short march range, where the cull prunes.
NEAR_DYNAMIC = dataclasses.replace(CULL_DYNAMIC, max_distance=8.0)
DESIGNS = ("design1", "design2", "logo")


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """{(scene, kind): ctypes library}: "chain" (the point/grid unit's cull,
    no gizmo), "chain_gizmo" (the dynamic renderer's, with the gizmo) per
    design and for the 89-group scene; the frames' culled and unculled
    renderers."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler (g++) to build the generated source")
    scenes = {name: get_design(name) for name in DESIGNS}
    scenes["many"] = many_groups_scene()
    builds = {}
    for name, scene in scenes.items():
        builds[(name, "chain")] = scene_source(scene, cull=1)
        builds[(name, "chain_gizmo")] = HOST_RENDER + scene_source(scene, CULL_DYNAMIC, cull=2)
    unculled = dataclasses.replace(CULL, march_cull=None)
    builds.update({
        ("design1", "render"): HOST_RENDER + scene_source(scenes["design1"], unculled),
        ("design2", "cull"): HOST_RENDER + scene_source(scenes["design2"], CULL, cull=1),
        ("design2", "render"): HOST_RENDER + scene_source(scenes["design2"], unculled),
        ("logo", "near_dynamic"): HOST_RENDER + scene_source(scenes["logo"], NEAR_DYNAMIC, cull=2),
        ("logo", "near"): HOST_RENDER + scene_source(
            scenes["logo"], dataclasses.replace(NEAR_DYNAMIC, march_cull=None)),
    })
    out = tmp_path_factory.mktemp("host_build_lanes")
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
        if key[1].startswith("chain"):
            lib.host_cull_tile.argtypes = [_P] * 6
            lib.host_cull_tile_lanes.argtypes = [_P] * 6
        if key[1] != "chain":
            lib.host_render.argtypes = [_P, ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P]
        if key[1] not in ("chain", "render", "near"):
            lib.host_dynamic_counts.argtypes = [_P]
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


def _boxes(seed, n, lo=-4.0, hi=4.0):
    """``n`` boxes from a numpy seed, wide and narrow (a tenth have a side
    near zero, as a warp's box of nearly one point)."""
    rng = np.random.default_rng(seed)
    low = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    size = rng.uniform(0.01, 2.0, (n, 3)) * rng.choice([0.001, 0.05, 1.0], (n, 1), p=[0.1, 0.3, 0.6])
    return low, (low + size).astype(np.float32)


def _chains(lib, scene, plan, low, high):
    """(predicate words u32[n, W], substitutes f32[n, S]) of the one-thread
    chain and of the lane chain on each box."""
    bank, ad, ex = _bank(scene.arrays), scene.arrays.ad, _extras(scene)
    words = max(1, -(-len(plan.groups) // 32))
    out = {}
    for fn in ("host_cull_tile", "host_cull_tile_lanes"):
        preds = np.zeros((len(low), words), np.uint32)
        substs = np.zeros((len(low), plan.n_slots), np.float32)
        for b in range(len(low)):
            box = np.ascontiguousarray(np.stack([low[b], high[b]], -1).reshape(6), np.float32)
            getattr(lib, fn)(box.ctypes.data, bank.ctypes.data, ad.ctypes.data, _ptr(ex),
                             preds[b].ctypes.data, substs[b].ctypes.data)
        out[fn] = (preds, substs)
    return out


def _plain_culler(scene, gizmo, low, high):
    """The plain culler's (bool[n, G], f32[n, S]) on the same boxes."""
    culler = cull.make_tape_culler(scene, gizmo=gizmo)
    boxes = tuple((torch.from_numpy(low[:, i]), torch.from_numpy(high[:, i])) for i in range(3))
    return cull.stack_cull(*culler(boxes, cull.array_bank_reader(scene.arrays),
                                   eval_context(scene, scene.arrays.to_torch("cpu"))), (len(low),))


@pytest.mark.parametrize("gizmo", [False, True])
@pytest.mark.parametrize("name", DESIGNS)
def test_lane_chain_bit_equal_to_cull_tile_and_plain_culler(host_libs, name, gizmo):
    """The lane chain, its 32 lanes emulated and its shuffles read from the
    lanes' array, gives ``cull_tile``'s predicate words and substitutes bit
    for bit on 96 boxes from a seed, and the plain culler's."""
    scenes, libs = host_libs
    scene = scenes[name]
    plan = cull.make_cull_plan(scene, gizmo)
    low, high = _boxes(11, 96)
    got = _chains(libs[(name, "chain_gizmo" if gizmo else "chain")], scene, plan, low, high)
    (p_tile, s_tile), (p_lanes, s_lanes) = got["host_cull_tile"], got["host_cull_tile_lanes"]
    np.testing.assert_array_equal(p_lanes, p_tile)
    np.testing.assert_array_equal(s_lanes.view(np.uint32), s_tile.view(np.uint32))
    p, s = _plain_culler(scene, gizmo, low, high)
    bits = (p_lanes[:, 0:1] >> np.arange(len(plan.groups), dtype=np.uint32)) & 1
    np.testing.assert_array_equal(bits, p.numpy().astype(np.uint32))
    np.testing.assert_array_equal(s_lanes, s.numpy())
    assert (bits == 0).any() or name == "design2"


def test_lane_chain_over_many_chunks(host_libs):
    """89 cull groups over 133 slots: five chunks of 32 lanes, three
    predicate words, bit-equal to ``cull_tile`` and the plain culler on
    boxes over the scene's 11x4 grid of parts."""
    scenes, libs = host_libs
    scene = scenes["many"]
    plan = cull.make_cull_plan(scene, False)
    assert plan.n_slots > 4 * 32 and len(plan.groups) == 89
    rng = np.random.default_rng(3)
    # A box about each part (torch_scenes.py places part i at x = i % 11 - 5,
    # y = i // 11 - 1.5), and four across the scene.
    part = np.arange(44)
    centre = np.stack([part % 11 - 5.0, part // 11 - 1.5, np.full(44, 0.15)], -1)
    centre = np.concatenate([centre, rng.uniform([-5, -1.5, 0], [5, 1.5, 0.3], (4, 3))])
    half = rng.uniform(0.05, 0.6, (48, 3))
    half[44:] *= 8.0
    low = (centre + rng.uniform(-0.2, 0.2, (48, 3)) - half).astype(np.float32)
    high = (low + 2 * half).astype(np.float32)
    got = _chains(libs[("many", "chain")], scene, plan, low, high)
    (p_tile, s_tile), (p_lanes, s_lanes) = got["host_cull_tile"], got["host_cull_tile_lanes"]
    np.testing.assert_array_equal(p_lanes, p_tile)
    np.testing.assert_array_equal(s_lanes.view(np.uint32), s_tile.view(np.uint32))
    p, s = _plain_culler(scene, False, low, high)
    groups = np.arange(len(plan.groups))
    bits = (p_lanes[:, groups // 32] >> (groups % 32).astype(np.uint32)) & 1
    np.testing.assert_array_equal(bits, p.numpy().astype(np.uint32))
    np.testing.assert_array_equal(s_lanes, s.numpy())
    # Groups in every word are both kept and skipped somewhere.
    for w in range(3):
        word = bits[:, 32 * w: 32 * (w + 1)]
        assert word.any() and not word.all()


def _render(lib, scene, config, cam_arrays):
    cam = np.ascontiguousarray(camera_rows(*cam_arrays), np.float32)
    img = np.empty((config.height, config.width, 3), np.float32)
    lib.host_render(img.ctypes.data, config.height, config.width, cam.ctypes.data,
                    _bank(scene.arrays).ctypes.data, scene.arrays.ad.ctypes.data,
                    _ptr(_extras(scene)), None)
    return img


@pytest.mark.parametrize("name,kind,unculled,config,zoom", [
    ("design1", "chain_gizmo", "render", CULL_DYNAMIC, None),
    ("design1", "chain_gizmo", "render", CULL_DYNAMIC, 3.0),
    ("design2", "cull", "render", CULL, None),
    ("logo", "near_dynamic", "near", NEAR_DYNAMIC, 6.0),
])
def test_host_culled_render_equals_unculled(host_libs, name, kind, unculled, config, zoom):
    """The host culled renderer equals the unculled host render bit for bit
    at 64x48: Design1 dynamic, whose warps run the lane chain, from the
    orbit and close up; Design2 hoisted, on the one-thread chain; and Logo
    close up dynamic, where the plain version skips over a tenth of the
    group evaluations.  In the dynamic mode the warps' points
    leave the held box mid-march, and steps inside it run no chain
    (csrc/march.cuh hold_box)."""
    scenes, libs = host_libs
    scene = scenes[name]
    if zoom is not None:
        cam_arrays = Camera.initial(apply_default_orbit=False).zoom(zoom).as_arrays()
    else:
        cam_arrays = Camera.initial().orbit(0.3, -0.2).as_arrays()
    lib = libs[(name, kind)]
    counts = np.zeros(2, np.int64)
    lib.host_dynamic_counts(counts.ctypes.data)
    img = _render(lib, scene, config, cam_arrays)
    ref = _render(libs[(name, unculled)], scene, config, cam_arrays)
    np.testing.assert_array_equal(img, ref)
    assert (ref != 1.0).any(-1).mean() > 0.05
    lib.host_dynamic_counts(counts.ctypes.data)
    steps, chains = counts
    if config.march_cull == "dynamic":
        # The held box: the warps' points left it mid-march (more chains
        # than the 96 warps' first ones), and held steps ran no chain.
        warps = (config.width // 16) * (config.height // 2)
        assert warps < chains < steps
    if name == "logo":
        counts = {}
        make_renderer(scene, dataclasses.replace(config, width=32, height=16))(
            scene.arrays.to_torch("cpu"), *cam_arrays, cull_counts=counts)
        assert cull.skipped_share(counts) > 0.1


@pytest.mark.parametrize("name", DESIGNS)
def test_lane_chain_one_pass_per_brush_kind(name):
    """``cull_lane`` calls each interval body once, under the mask of its
    kind's lanes, so a warp issues it once per chunk: Design1 (9 spheres, a
    box, an empty slot and the gizmo) in four passes where ``cull_tile``
    makes twelve calls; the issue model counts fewer operations than the
    one-thread chain's, and Logo's letters stay one kind each."""
    scene = get_design(name)
    plan = cull.make_cull_plan(scene, True)
    text = cull_lane_function(plan)
    bodies = text.count("ivbrush_") + text.count("iv_gizmo(")
    kinds = {n.brush for n in _leaves(plan.root) if n.op == "leaf" and plan.twinned[n.brush]}
    assert bodies == len(kinds) + 1 and text.count("iv_local(") == 1
    model = lane_chain_ops(scene, True)
    assert model["kinds"] == bodies and model["chunks"] == 1
    assert model["shuffles"] == 2 * plan.n_slots
    assert model["fp32_ops"] < cull_chain_ops(scene, True)
    if name == "design1":
        assert bodies == 4 and plan.n_slots == 12
        assert model["fp32_ops"] < cull_chain_ops(scene, True) / 3


def _leaves(node):
    if node.op in ("leaf", "gizmo"):
        return [node]
    return [leaf for c in node.children for leaf in _leaves(c)]


def test_bank_placement_rules_and_object_limit():
    """The bank's placement and the dynamic cull's chain follow the rules
    the A/B chose (ops/cuda/tape.py): the renderer's bank (but the hoisted
    cull's) in constant memory above 4 objects (Design1, Logo), in shared
    memory below (Design2); K4's in shared memory without tables (Design1,
    Design2), in constant memory with tables (Logo); the point/grid unit's
    in shared memory; every dynamic unit generates the lane chain
    (``cull_lane`` and ``cull_tree``).  A constant bank refuses a scene
    above 1,365 objects."""
    d1, d2, logo = (get_design(n) for n in DESIGNS)
    for scene, unculled in ((d1, 1), (logo, 1), (d2, 0)):
        assert f"#define BANK_CONSTANT {unculled}" in march_kernel_source(
            scene, dataclasses.replace(CULL, march_cull=None))
        assert f"#define BANK_CONSTANT {unculled}" in march_kernel_source(scene, CULL_DYNAMIC)
        assert "#define BANK_CONSTANT 0" in march_kernel_source(scene, CULL)  # hoisted
    for scene, bank in ((d1, 0), (d2, 0), (logo, 1)):
        assert f"#define BANK_CONSTANT {bank}" in ray_march_kernel_source(scene, CULL)
    assert "#define BANK_CONSTANT 0" in sdf_kernel_source(d1)
    for scene in (d1, d2, logo, many_groups_scene()):
        src = march_kernel_source(scene, CULL_DYNAMIC)
        assert "HD Iv cull_lane(" in src and "HD void cull_tree(" in src
    assert BANK_CONSTANT_MAX_OBJECTS == 1365
    with pytest.raises(ValueError, match="1365"):
        scene_source(types.SimpleNamespace(num_objects=1366), bank="constant")
    assert many_groups_scene().num_objects < BANK_CONSTANT_MAX_OBJECTS


def test_wrappers_on_cpu_take_plain_and_refuse_debug_counters():
    """On CPU tensors the fit march takes its plain version, whatever the
    origin's type; the build with debug counters (the dynamic cull's
    evaluations and chains) needs the card and a dynamic cull."""
    scene = get_design("design2")
    config = RenderConfig(width=16, height=8, max_steps=40, gizmo=False)
    arrays = scene.arrays.to_torch("cpu")
    rows = camera_rows(*Camera.initial().as_arrays())
    rays = torch.from_numpy(np.random.default_rng(0).normal(size=(37, 3)).astype(np.float32))
    d, vmin = make_cuda_ray_march(scene, config)(arrays, torch.from_numpy(rows[0]), rays)
    d_ref, vmin_ref = make_cuda_ray_march(scene, config).plain(arrays, rows[0], rays)
    assert torch.equal(d, d_ref) and torch.equal(vmin, vmin_ref) and d.shape == (37,)
    cam = Camera.initial().as_arrays()
    with pytest.raises(ValueError, match="CUDA"):
        make_cuda_renderer(scene, dataclasses.replace(CULL_DYNAMIC, width=16, height=8),
                           cull_stats=True)(arrays, *cam)
    with pytest.raises(ValueError, match="dynamic"):
        make_cuda_renderer(scene, CULL, cull_stats=True)


def test_stream_handle_orders_constant_bank_launches(monkeypatch):
    """A unit whose object bank is module-global state (a constant bank)
    launches on the stream of its first launch only, and never under CUDA
    graph capture; a unit with its bank in shared memory takes any stream.
    The CUDA stream calls are stood in for on the CPU."""
    current = {"stream": 11, "capturing": False}
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=current["stream"]))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: current["capturing"])
    constant = types.SimpleNamespace(global_bank=True, bank_stream=None)
    shared = types.SimpleNamespace(global_bank=False, bank_stream=None)
    assert stream_handle("cuda", constant).value == 11
    assert stream_handle("cuda", constant).value == 11
    current["stream"] = 12
    assert stream_handle("cuda", shared).value == 12
    with pytest.raises(RuntimeError, match="one stream"):
        stream_handle("cuda", constant)
    current.update(stream=11, capturing=True)
    with pytest.raises(RuntimeError, match="graph"):
        stream_handle("cuda", constant)
    assert stream_handle("cuda", shared).value == 11
