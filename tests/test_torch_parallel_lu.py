"""The port's mesh, collectives, comm models, distributed LU and dd solve
against the JAX package (``parallel/mesh``, ``comm``, ``distributed_lu``,
``distributed_dd``).

The JAX side runs here on conftest's 8 virtual CPU devices at the JAX
tests' shapes (``tests/test_distributed_lu.py``,
``test_distributed_dd.py``, ``test_comm_volume.py``); the port's side in
a module-scoped pool of 8 gloo ranks (``torch_parallel_worker``).
Tolerances: the LU factor, det and solve to float32 rounding with equal
``perm`` and ``ok``; the comm meter's calls and bytes equal to the JAX
meter's and to the analytic models exactly; the dd solution to 1e-10
relative."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import Mesh, PartitionSpec as P

from linalg_solver_tpu.parallel import comm as jcomm
from linalg_solver_tpu.parallel import distributed_lu as jlu
from linalg_solver_tpu.parallel.distributed_dd import distributed_solve_dd
from linalg_solver_tpu.parallel.mesh import make_mesh as jmake_mesh
from linalg_solver_tpu_torch.parallel import comm, distributed_lu as tlu
from linalg_solver_tpu_torch.parallel import mesh as tmesh

import torch
import torch_parallel_worker as W

LU = "parallel.distributed_lu."


@pytest.fixture(scope="module")
def pool():
    p = W.Pool(W.WORLD)
    yield p
    p.close()


def make_matrix(n, seed=0, shift=None):
    rng = np.random.RandomState(seed)
    shift = shift if shift is not None else 3.0 * np.sqrt(n)
    return (rng.randn(n, n) + shift * np.eye(n)).astype(np.float32)


def _f32_close(got, want, scale=1.0):
    """Agreement to float32 rounding: a few hundred ulps of the scale."""
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5 * scale)


def test_mesh_layout_specs_and_errors_match_jax(pool):
    got = pool.run("mesh_info", 4, 2)
    jm = jmake_mesh(dp=4, tp=2)
    for rank, (names, shape, coord) in enumerate(got):
        assert names == jm.axis_names and shape == jm.devices.shape
        pos = np.argwhere(jm.devices == jax.devices()[rank])[0]
        assert coord == tuple(int(i) for i in pos)
    assert pool.run("mesh_info", None, 2)[0][1] == jmake_mesh(tp=2).devices.shape
    for dp, tp in ((16, 2), (None, 3)):
        with pytest.raises(ValueError) as e:
            jmake_mesh(dp=dp, tp=tp)
        assert pool.run("mesh_info", dp, tp)[0] == ("ValueError", str(e.value))
    assert tmesh.batch_spec() == tuple(P("dp", None, None))
    assert tmesh.batch_vec_spec() == tuple(P("dp", None))
    assert tmesh.replicated_spec(3) == tuple(P(None, None, None))
    # shard_batch gives each rank the block JAX places on its device
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    from linalg_solver_tpu.parallel.mesh import shard_batch
    placed = shard_batch(jnp.asarray(x), jm)
    res = pool.run("call", "parallel.mesh.shard_batch", 4, 2, [x, W.MESH])
    for shard_ in placed.addressable_shards:
        rank = jax.devices().index(shard_.device)
        np.testing.assert_array_equal(res[rank]["out"], np.asarray(shard_.data))


def test_collectives_equal_lax_on_the_same_shards(pool):
    """psum, pmax, all_gather (stacked and tiled) and ppermute (a partial
    permutation: a rank that receives nothing gets zeros) against
    ``lax`` under ``shard_map`` on a (2, 4) mesh's tp axis."""
    x = np.random.RandomState(0).randn(8, 3).astype(np.float32)
    perm = [(0, 1), (1, 2), (3, 0)]
    jm = jmake_mesh(dp=2, tp=4)

    def body(v):
        return (lax.psum(v, "tp"), lax.pmax(v, "tp"),
                lax.all_gather(v, "tp"), lax.all_gather(v, "tp", tiled=True),
                lax.ppermute(v, "tp", perm))

    want = shard_map(body, mesh=jm, in_specs=P(("dp", "tp"), None),
                     out_specs=(P(("dp", "tp"), None),) * 2
                     + (P(("dp", "tp"), None, None), P(("dp", "tp"), None),
                        P(("dp", "tp"), None)),
                     check_vma=False)(jnp.asarray(x))
    got = pool.run("collectives", 2, 4, x, perm)
    for rank, (s, m, g, gt, pp, meter) in enumerate(got):
        np.testing.assert_allclose(s, np.asarray(want[0])[rank:rank + 1],
                                   rtol=1e-6)
        np.testing.assert_array_equal(m, np.asarray(want[1])[rank:rank + 1])
        np.testing.assert_array_equal(
            g, np.asarray(want[2])[4 * rank:4 * rank + 4])
        np.testing.assert_array_equal(
            gt, np.asarray(want[3])[4 * rank:4 * rank + 4])
        np.testing.assert_array_equal(pp, np.asarray(want[4])[rank:rank + 1])
        assert meter == {"calls": {"psum": 1, "pmax": 1, "all_gather": 2,
                                   "ppermute": 1},
                         "bytes": {"psum": 12, "pmax": 12, "all_gather": 24,
                                   "ppermute": 12}}


@pytest.mark.parametrize("tp", [1, 2, 4, 8])
def test_solve_and_det_match_jax(pool, tp):
    mesh = jmake_mesh(dp=8 // tp, tp=tp)
    n = 32
    A = make_matrix(n, seed=1)
    b = np.random.RandomState(2).randn(n).astype(np.float32)
    want = np.asarray(jlu.distributed_solve(jnp.asarray(A), jnp.asarray(b),
                                            mesh, axis="tp", nb=4))
    got = pool.run("call", LU + "distributed_solve", 8 // tp, tp,
                   [A, b, W.MESH], {"axis": "tp", "nb": 4})
    for r in got:
        _f32_close(r["out"], want, np.abs(want).max())
        np.testing.assert_array_equal(r["out"], got[0]["out"])
    # det at n = 8·tp, normalized so that |det| ~ 1 (the JAX test's input)
    n = 8 * tp
    A = make_matrix(n, seed=5, shift=2.0).astype(np.float64)
    _, logdet = np.linalg.slogdet(A)
    A = (A / np.exp(logdet / n)).astype(np.float32)
    want = float(jlu.distributed_det(jnp.asarray(A), mesh, axis="tp", nb=4))
    got = pool.run("call", LU + "distributed_det", 8 // tp, tp, [A, W.MESH],
                   {"axis": "tp", "nb": 4})
    for r in got:
        np.testing.assert_allclose(float(r["out"]), want, rtol=5e-5)


def test_factor_perm_ok_matrix_rhs_and_singular_match_jax(pool):
    n, nb = 16, 4
    mesh = jmake_mesh(dp=2, tp=4)
    A = make_matrix(n, seed=6, shift=2.0)
    jres = jlu.distributed_lu(jnp.asarray(A), mesh, axis="tp", nb=nb)
    got = pool.run("call", LU + "distributed_lu", 2, 4, [A, W.MESH],
                   {"axis": "tp", "nb": nb})
    lu_cyc = W.collect(got, "tp", dim=1, field="lu_sharded")
    _f32_close(lu_cyc, np.asarray(jres.lu_sharded), np.abs(A).max())
    for r in got:
        np.testing.assert_array_equal(r["out"]["perm"], np.asarray(jres.perm))
        assert bool(r["out"]["ok"]) and float(r["out"]["sign"]) == float(
            jres.sign)
    packed = tlu.gather_packed_lu(
        tlu.DistributedLUResult(torch.from_numpy(lu_cyc), *[None] * 3), nb, 4)
    np.testing.assert_array_equal(
        packed.numpy(), lu_cyc[:, np.argsort(
            np.asarray(jlu.cyclic_column_order(n, nb, 4)))])
    # a matrix right-hand side
    B = np.random.RandomState(4).randn(n, 3).astype(np.float32)
    A3 = make_matrix(n, seed=3)
    want = np.asarray(jlu.distributed_solve(jnp.asarray(A3), jnp.asarray(B),
                                            mesh, axis="tp", nb=nb))
    got = pool.run("call", LU + "distributed_solve", 2, 4, [A3, B, W.MESH],
                   {"axis": "tp", "nb": nb})
    _f32_close(got[0]["out"], want, np.abs(want).max())
    # a singular matrix: ok False and det 0 in both packages
    S = make_matrix(8, seed=9)
    S[:, 0] = 0.0
    S[0, :] = 0.0
    mesh = jmake_mesh(dp=4, tp=2)
    jres = jlu.distributed_lu(jnp.asarray(S), mesh, axis="tp", nb=4)
    jdet = float(jlu.distributed_det(jnp.asarray(S), mesh, axis="tp", nb=4))
    res = pool.run("call", LU + "distributed_lu", 4, 2, [S, W.MESH],
                   {"axis": "tp", "nb": 4})
    det = pool.run("call", LU + "distributed_det", 4, 2, [S, W.MESH],
                   {"axis": "tp", "nb": 4})
    assert not bool(jres.ok) and not bool(res[0]["out"]["ok"])
    np.testing.assert_array_equal(res[0]["out"]["perm"], np.asarray(jres.perm))
    assert jdet == float(det[0]["out"]) == 0.0


def _jax_meter(fn):
    jax.clear_caches()       # a fresh trace under the meter
    with jcomm.CommMeter() as m:
        jax.block_until_ready(fn())
    return {"calls": dict(m.calls), "bytes": dict(m.bytes)}


def test_comm_meter_equals_jax_meter_and_model(pool):
    """Each LU factor and solve's collectives, counted as they run, equal
    the JAX meter's trace-time count and the analytic model, in calls and
    bytes (the weak-scaling series runs in ``dryrun_multichip``)."""
    cases = [("distributed_lu", D, nb, nb * D * mult, None)
             for D, nb, mult in ((2, 4, 2), (4, 4, 2), (8, 2, 1))]
    cases += [("distributed_solve", 4, 4, 32, k) for k in (1, 3)]
    for name, D, nb, n, k in cases:
        a = make_matrix(n, seed=D)
        args = [a] if k is None else [
            a, np.random.RandomState(2).randn(n, k).astype(np.float32)]
        jm = Mesh(np.array(jax.devices()[:D]), ("tp",))
        jm_fn = getattr(jlu, name)
        want = _jax_meter(lambda: jm_fn(*map(jnp.asarray, args), jm,
                                        axis="tp", nb=nb))
        model = (jcomm.model_lu_factor(n, nb) if k is None
                 else jcomm.model_lu_solve(n, nb, k_rhs=k))
        got = pool.run("call", LU + name, 1, D, args + [W.MESH],
                       {"axis": "tp", "nb": nb}, meter=True)
        assert want == model, (name, D, want)
        for r in got[:D]:
            assert r["meter"] == model, (name, D, n, k, r["meter"])
        assert all(r is None for r in got[D:])


def test_dd_solve_matches_jax(pool):
    """Row-local float64 residuals: the refined x_hi + x_lo agrees with the
    JAX package's float-float solve to 1e-10 relative, both reach a
    1e-11 residual, and ``ok`` agrees."""
    rng = np.random.RandomState(0)
    n = 64
    U, _ = np.linalg.qr(rng.randn(n, n))
    V, _ = np.linalg.qr(rng.randn(n, n))
    A = ((U * np.logspace(0, -3, n)[None, :]) @ V.T).astype(np.float32)
    b = (A.astype(np.float64) @ rng.randn(n)).astype(np.float32)
    r = distributed_solve_dd(jnp.asarray(A), jnp.asarray(b),
                             jmake_mesh(dp=2, tp=4), axis="tp")
    want = np.asarray(r.x_hi, np.float64) + np.asarray(r.x_lo, np.float64)
    got = pool.run("call", "parallel.distributed_dd.distributed_solve_dd",
                   2, 4, [A, b, W.MESH], {"axis": "tp"})
    A64, b64 = A.astype(np.float64), b.astype(np.float64)
    for g in got:
        x = g["out"]["x_hi"].astype(np.float64) + g["out"]["x_lo"]
        assert bool(g["out"]["ok"]) == bool(r.ok) is True
        assert np.abs(x - want).max() <= 1e-10 * np.abs(want).max()
        assert np.abs(A64 @ x - b64).max() / np.abs(b).max() < 1e-11


def test_models_orders_and_alpha_beta_equal_jax_with_its_constants():
    """The static half: ``cyclic_column_order``, ``default_block``, every
    analytic model, and the α-β projections, which in the port take the
    latency and bandwidth as arguments (here the JAX package's own)."""
    alpha, bw = jcomm.ICI_ALPHA_S, jcomm.ICI_BW_BPS
    for n, nb, d in ((24, 4, 3), (16, 2, 4), (64, 8, 2)):
        np.testing.assert_array_equal(
            tlu.cyclic_column_order(n, nb, d).numpy(),
            np.asarray(jlu.cyclic_column_order(n, nb, d)))
    for n, d in ((32, 4), (96, 8), (2048, 1), (48, 16)):
        assert tlu.default_block(n, d) == jlu.default_block(n, d)
    with pytest.raises(ValueError):
        tlu.default_block(30, 4)
    for n, nb, k in ((32, 4, 1), (64, 8, 3), (2048, 128, 1)):
        assert comm.model_lu_factor(n, nb) == jcomm.model_lu_factor(n, nb)
        assert (comm.model_lu_solve_body(n, nb, k)
                == jcomm.model_lu_solve_body(n, nb, k))
        assert comm.model_lu_solve(n, nb, k) == jcomm.model_lu_solve(n, nb, k)
    for n, p, w, s in ((64, 4, 8, 3), (256, 1, 128, 2), (1024, 8, 64, 4)):
        assert (comm.model_eigh_per_sweep(n, p, w)
                == jcomm.model_eigh_per_sweep(n, p, w))
        m = comm.model_eigh_adaptive(n, p, w, s)
        assert m == jcomm.model_eigh_adaptive(n, p, w, s)
        assert comm.model_eigh(n, p, w, s) == jcomm.model_eigh(n, p, w, s)
        for D in (1, 4, 8):
            assert (comm.time_alpha_beta(m, D, alpha, bw)
                    == jcomm.time_alpha_beta(m, D))
            assert (comm.time_alpha_beta_band(m, D, alpha, bw)
                    == jcomm.time_alpha_beta_band(m, D))
    assert (comm.projected_eigh_scaling(1024, alpha, bw)
            == jcomm.projected_eigh_scaling(1024))
    assert (comm.projected_eigh_scaling_band(1024, alpha, bw, Ds=(8, 16))
            == jcomm.projected_eigh_scaling_band(1024, Ds=(8, 16)))
    with pytest.raises(TypeError):
        comm.time_alpha_beta(m, 8)      # no interconnect constant built in


def test_panel_factor_matches_jax_on_ties():
    """The redundant panel factorization (``ops.lu_blocked._panel_factor``,
    plain torch) against the JAX package's XLA loop: a panel whose columns
    hold equal magnitudes (±2 in rows 1, 3 and 6 of column 0) takes the
    first maximum as JAX's ``argmax`` does, so the permutations and
    parities are equal and the factored panels agree to f32 rounding."""
    import importlib

    from linalg_solver_tpu_torch.ops.lu_blocked import _panel_factor

    jlb = importlib.import_module("linalg_solver_tpu.ops.lu_blocked")
    rng = np.random.RandomState(12)
    panel = rng.randn(3, 12, 4).astype(np.float32)
    panel[:, [1, 3, 6], 0] = [2.0, -2.0, 2.0]
    panel[1, :, 1] = panel[1, :, 0]          # a zero pivot after step 0
    for k0 in (0, 2):
        want = jlb._panel_factor(jnp.asarray(panel), k0, 4, jnp.arange(12),
                                 jnp.asarray(1e-6, jnp.float32))
        got = _panel_factor(torch.from_numpy(panel), k0, 4,
                            torch.arange(12), 1e-6)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
        _f32_close(got[0].numpy(), np.asarray(want[0]), 4.0)
