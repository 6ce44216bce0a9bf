"""K6's dense planes against the rank form they expand.

Logo's letters are baked as rank-32 factor tables (the JAX package's form,
sampled by its ops/pallas/table.py ``packed_rank_sample``).  The port's
kernels sample each letter's four dense planes instead
(designs/logo.py ``letter_planes``, ops/table.py ``plane_sample`` and its
C++ twin csrc/table.cuh ``plane_sample``).  Here, on seeded samples of every
letter: the planes against the port's f32 rank sum (atol 1e-6) and against
the rank form in float64 (atol 2e-7: the planes are summed in float64 and
rounded once, closer to it than the f32 sum), their gradients in the grid
coordinates under autograd and ``torch.func`` against the rank sum's (atol
1e-5), and planes built from the JAX package's own tables against the
port's (atol 1e-6).
"""

import numpy as np
import pytest
import torch

from designs import logo as jlogo
from designcsg_tpu_torch.designs import get_design
from designcsg_tpu_torch.designs import logo as tlogo
from designcsg_tpu_torch.ops.table import GRID_MAX, PLANES, TABLE_WIDTH, packed_rank_sample, plane_sample

LETTERS = ["logo_0_C", "logo_1_S", "logo_2_G"]
N = 1 << 19
N_GRAD = 1 << 16


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread per test process: the suite runs one process per
    worker, and a default-sized thread pool in each oversubscribes the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tables():
    """{letter: (rank table f32[128, 128], planes f32[128, 128, 4])} as the
    compiled Logo carries them (CompiledScene.extras, .derived_extras)."""
    scene = get_design("logo")
    planes = dict(scene.derived_extras)
    assert [name for name, _ in scene.extras] == LETTERS
    assert list(planes) == [f"{name}_planes" for name in LETTERS]
    return {name: (table, planes[f"{name}_planes"]) for name, table in scene.extras}


def _coords(seed: int, n: int):
    """Grid coordinates over the table and a cell beyond it on each side
    (the samplers clip them)."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(-1.0, TABLE_WIDTH, (2, n)).astype(np.float32)
    return torch.from_numpy(g[0]), torch.from_numpy(g[1])


def _rank_f64(table: np.ndarray, gx: torch.Tensor, gy: torch.Tensor) -> np.ndarray:
    """The rank form in float64 from the f32 table, at the f32 cells and
    fractions the samplers take."""
    gx = np.clip(gx.numpy(), np.float32(0.0), np.float32(GRID_MAX))
    gy = np.clip(gy.numpy(), np.float32(0.0), np.float32(GRID_MAX))
    c0, r0 = np.floor(gx), np.floor(gy)
    fx, fy = (gx - c0).astype(np.float64), (gy - r0).astype(np.float64)
    c0, r0 = c0.astype(np.int64), r0.astype(np.int64)
    t = table.astype(np.float64)
    k = t.shape[0] // 4
    u = t[:k][:, c0] + fx * t[k : 2 * k][:, c0]
    v = t[2 * k : 3 * k][:, r0] + fy * t[3 * k :][:, r0]
    return (u * v).sum(0)


@pytest.mark.parametrize("letter", LETTERS)
def test_planes_match_rank_sum(tables, letter):
    table, planes = tables[letter]
    assert planes.shape == (TABLE_WIDTH, TABLE_WIDTH, PLANES) and planes.dtype == np.float32
    gx, gy = _coords(1, N)
    got = plane_sample(torch.from_numpy(planes), gx, gy)
    ref = packed_rank_sample(torch.from_numpy(table), gx, gy)
    assert float(ref.min()) < -0.3 and float(ref.max()) > 0.7
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("letter", LETTERS)
def test_planes_match_float64_rank_form(tables, letter):
    table, planes = tables[letter]
    gx, gy = _coords(2, N)
    got = plane_sample(torch.from_numpy(planes), gx, gy).numpy().astype(np.float64)
    np.testing.assert_allclose(got, _rank_f64(table, gx, gy), rtol=0, atol=2e-7)


def _grads(sample, tbl, gx, gy):
    """(d/dgx, d/dgy) of ``sample(tbl, gx, gy).sum()`` by autograd and by
    ``torch.func.grad``."""
    x, y = gx.clone().requires_grad_(), gy.clone().requires_grad_()
    auto = torch.autograd.grad(sample(tbl, x, y).sum(), (x, y))
    func = torch.func.grad(lambda a, b: sample(tbl, a, b).sum(), argnums=(0, 1))(gx, gy)
    return auto, func


@pytest.mark.parametrize("letter", LETTERS)
def test_planes_gradients_match_rank_sum(tables, letter):
    """The slopes ``SA + fy*SS`` along x and ``AS + fx*SS`` along y against
    the rank sum's, under autograd and ``torch.func``; 0 where clipped."""
    table, planes = tables[letter]
    gx, gy = _coords(3, N_GRAD)
    (pa, pf) = _grads(plane_sample, torch.from_numpy(planes), gx, gy)
    (ra, rf) = _grads(packed_rank_sample, torch.from_numpy(table), gx, gy)
    for got, ref in ((pa, ra), (pf, rf), (pa, pf)):
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0, atol=1e-5)
    outside = (gx < 0) | (gx > GRID_MAX)
    assert bool(outside.any()) and bool((pa[0][outside] == 0).all())
    assert float(pa[0].abs().max()) > 0.05 and float(pa[1].abs().max()) > 0.05


def test_plane_sample_keeps_shape_and_refuses_rank_table(tables):
    table, planes = tables[LETTERS[0]]
    gx, gy = _coords(4, 24)
    out = plane_sample(torch.from_numpy(planes), gx.reshape(2, 3, 4), gy.reshape(2, 3, 4))
    assert out.shape == (2, 3, 4)
    np.testing.assert_array_equal(out.reshape(-1).numpy(),
                                  plane_sample(torch.from_numpy(planes), gx, gy).numpy())
    with pytest.raises(ValueError, match="planes must be"):
        plane_sample(torch.from_numpy(table), gx, gy)


@pytest.mark.parametrize("index", range(3))
def test_planes_from_jax_tables_match(tables, index):
    """The JAX package's bake of the same glyphs (designs/logo.py
    ``_bake_letter_tables``), expanded into planes, against the port's."""
    letter = LETTERS[index]
    segments, bits = tlogo.load_glyphs()["CSG"[index]]
    jtable = np.asarray(jlogo._bake_letter_tables(segments, np.asarray(bits)), np.float32)
    np.testing.assert_allclose(tlogo.letter_planes(jtable), tables[letter][1], rtol=0, atol=1e-6)
