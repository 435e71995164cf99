"""Parity of the port's parallel layer (`cfjax_torch.parallel`) with
cfjax's, on the CPU in float64.

One 4-rank gloo world is spawned for the module (`run_world`, a FileStore
rendezvous): it runs every case of `torch_parallel_cases.world_cases` on a
1-D ("data",) mesh and a 2 x 2 ("rows", "cols") mesh, and each test reads
rank 0's cached results. The same numpy inputs go through cfjax's sharded
functions here, on a jax mesh of the same shape over four of the eight
CPU devices. The ranks' CG iterations and solutions are compared across
ranks bit for bit. Single-rank groups (no world spawned: `init_distributed`
and `default_mesh` with nothing initialised, a world-size-1 dense MVM) run
in this process and are destroyed after each test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

import cfjax.kernels as jk
import cfjax_torch
import cfjax_torch.kernels as tk
import torch_parallel_cases as cases
from cfjax.barneshut import BarnesHutFactorization as JBarnesHut
from cfjax.derivative import gradient as jg
from cfjax.operators import cg as jcg, nystrom_preconditioner as jnystrom
from cfjax.operators.kronecker import KroneckerOperator as JKronecker
from cfjax.operators.toeplitz import ToeplitzOperator as JToeplitz
from cfjax.parallel import (
    ShardedGradientGramian as JShardedGradient,
    ShardedGramian as JShardedGramian,
    ShardedHessianGramian as JShardedHessian,
    ShardedValueGradientGramian as JShardedValueGradient,
    sharded_bh_matvec as j_bh,
    sharded_block_apply as j_block_apply,
    sharded_cg as j_sharded_cg,
    sharded_gramian_matvec as j_matvec,
    sharded_kronecker_matvec as j_kron,
    sharded_toeplitz_matmat as j_toeplitz,
)
from cfjax.parallel.mesh import sharded_gramian_matvec_2d as j_matvec_2d
from cfjax_torch.parallel import ShardedGramian, default_mesh, init_distributed
from cfjax_torch.utils.testing import run_world

torch.set_num_threads(2)

REL = 1e-10   # float64 MVMs: the same terms, summed per shard and gathered


def jmesh1():
    return Mesh(np.array(jax.devices()[:4]), ("data",))


def jmesh2():
    return Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("rows", "cols"))


def _data():
    """Every case's numpy inputs, from one seed."""
    r = np.random.default_rng(42)
    x512 = r.uniform(-4, 4, (512, 2))
    dims = (13, 6, 5)   # leading mode not divisible by 4
    return {
        "dense": (r.standard_normal((100, 3)), r.standard_normal(100)),
        "uneven": (r.standard_normal((101, 3)), r.standard_normal(101)),
        "solve": (r.standard_normal((96, 2)), r.standard_normal(96)),
        "pcg2d": (x512, np.sin(x512[:, 0])),
        "grad": (r.standard_normal((37, 5)), r.standard_normal(37 * 5)),
        "grad_2d": (r.standard_normal((37, 3)), r.standard_normal(37 * 3)),
        "valgrad": (r.standard_normal((21, 4)), r.standard_normal(21 * 5)),
        "hessian": (r.standard_normal((13, 3)), r.standard_normal(13 * 9)),
        "bh": (r.standard_normal((600, 2)), r.random(600)),
        "kron": tuple(r.standard_normal((m, m)) for m in dims)
        + (r.standard_normal(int(np.prod(dims))),),
        "toeplitz": (r.standard_normal(64), r.standard_normal((64, 11))),   # 11 columns
    }


@pytest.fixture(scope="module")
def data():
    return _data()


@pytest.fixture(scope="module")
def world(data):
    """rank 0's results of every case in one spawned 4-rank gloo world."""
    return run_world(cases.world_cases, 4, data, backend="gloo", device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    """Input without a device goes to the CPU in this module's in-process
    tests; the configured device is restored after them."""
    shipped = cfjax_torch.config.DEFAULT.device
    cfjax_torch.set_config(device="cpu")
    yield
    cfjax_torch.set_config(device=shipped)


@pytest.fixture
def one_rank():
    """No process group before the test; the one it makes is destroyed."""
    assert not dist.is_initialized()
    yield
    dist.destroy_process_group()


def test_world_meshes(world):
    assert world["world"] == 4
    assert world["mesh_names"] == ("data",)
    # one node (LOCAL_WORLD_SIZE unset) with an even rank count: 2 rows
    assert world["mesh2_shape"] == (2, 2) and world["mesh2_names"] == ("rows", "cols")


def test_sharded_mvm_matches_cfjax(world, data):
    x, a = data["dense"]
    ref = JShardedGramian(jk.MaternP(2), jnp.asarray(x), mesh=jmesh1(), block=16) @ jnp.asarray(a)
    np.testing.assert_allclose(world["dense"], np.asarray(ref), rtol=REL)
    assert world["dense_shard_rows"] == 25


@pytest.mark.parametrize("form", ["tensor", "dtensor"])
def test_sharded_matvec_uneven_rows(world, data, form):
    # n = 101 is not divisible by 4: zero rows pad the last shard, or
    # (DTensor) torch.chunk's blocks are padded to gather
    x, a = data["uneven"]
    xj = jnp.asarray(x)
    ref = j_matvec(jk.EQ(), xj, xj, jnp.asarray(a), "iso", jmesh1(), block=16)
    got = world["uneven"] if form == "tensor" else world["uneven_dtensor"]
    np.testing.assert_allclose(got, np.asarray(ref), rtol=REL)


def test_sharded_solve(world, data):
    x, a = data["solve"]
    op = JShardedGramian(jk.EQ(), jnp.asarray(x), mesh=jmesh1(), block=16).add_diagonal(1e-4)
    ref, _ = j_sharded_cg(op._matvec, jnp.asarray(a), tol=1e-12, maxiter=500)
    np.testing.assert_allclose(world["solve"], np.asarray(ref), rtol=1e-6)


@pytest.mark.parametrize("case", ["solve", "pcg2d"])
def test_ranks_agree_bit_for_bit(world, case):
    its, xs = world[f"{case}_iters_ranks"], world[f"{case}_ranks"]
    assert (its == its[0]).all()
    assert (xs == xs[0]).all()


def test_sharded_pcg_2d_matches_cfjax(world, data):
    x, y = map(jnp.asarray, data["pcg2d"])
    k = jk.Lengthscale(jk.EQ(), 1.0)
    M = jnystrom(k, x, 1e-2, rank=64)
    mesh = jmesh2()
    mv = lambda v: j_matvec_2d(k, x, x, v, "iso", mesh, block=64) + 1e-2 * v
    ref, (it, _) = jcg(mv, y, tol=1e-10, maxiter=200, M=M)
    np.testing.assert_allclose(world["pcg2d"], np.asarray(ref), rtol=1e-7, atol=1e-9)
    assert abs(int(world["pcg2d_iters"]) - int(it)) <= 3 and int(it) < 150


@pytest.mark.parametrize("name", list(cases.GRAD_KERNELS))
def test_sharded_gradient_matches_cfjax(world, data, name):
    k = {"MaternP2": jk.MaternP(2), "Dot2": jk.Dot() ** 2}[name]
    x, v = map(jnp.asarray, data["grad"])
    ref = JShardedGradient(k, x, mesh=jmesh1(), block=8) @ v
    np.testing.assert_allclose(world[f"grad_{name}"], np.asarray(ref), rtol=REL)


def test_sharded_gradient_2d_column_sum(world, data):
    x, v = map(jnp.asarray, data["grad_2d"])
    ref = JShardedGradient(jk.EQ(), x, mesh=jmesh2(), row_axis="rows", col_axis="cols",
                           block=8) @ v
    np.testing.assert_allclose(world["grad_2d"], np.asarray(ref), rtol=REL)
    # float64 CPU shards take the plain path, and say why
    assert "cpu" in world["grad_2d_reason"]


def test_sharded_block_apply_2d(world, data):
    x, v = map(jnp.asarray, data["grad_2d"])
    ref = j_block_apply(jg.grad_matvec_iso, jk.EQ(), x, x, (v.reshape(x.shape[0], -1),),
                        jmesh2(), "rows", "cols", block=8)
    np.testing.assert_allclose(world["block_apply_2d"], np.asarray(ref), rtol=REL)


def test_sharded_valuegradient_matches_cfjax(world, data):
    x, v = map(jnp.asarray, data["valgrad"])
    ref = JShardedValueGradient(jk.RQ(1.5), x, mesh=jmesh1(), block=8) @ v
    np.testing.assert_allclose(world["valgrad"], np.asarray(ref), rtol=REL)


def test_sharded_hessian_matches_cfjax(world, data):
    x, v = map(jnp.asarray, data["hessian"])
    ref = JShardedHessian(jk.EQ(), x, mesh=jmesh1(), block=4) @ v
    np.testing.assert_allclose(world["hessian"], np.asarray(ref), rtol=REL)


def test_sharded_barneshut(world, data):
    x, w = map(jnp.asarray, data["bh"])
    F = JBarnesHut(jk.EQ(), x, theta=0.25, group_size=16)
    ref = j_bh(F, w, jmesh1())
    # against the port's own single-rank MVM: the same plans, contracted
    # per group; against cfjax's sharded MVM at the packages' BH parity
    np.testing.assert_allclose(world["bh"], world["bh_single"], rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(world["bh"], np.asarray(ref), rtol=REL)


def test_sharded_kronecker(world, data):
    *mats, a = map(jnp.asarray, data["kron"])
    ref = j_kron(JKronecker(mats), a, jmesh1())
    np.testing.assert_allclose(world["kron"], np.asarray(ref), rtol=REL)


def test_sharded_toeplitz_matmat(world, data):
    col, V = map(jnp.asarray, data["toeplitz"])
    ref = j_toeplitz(JToeplitz(col), V, jmesh1())
    np.testing.assert_allclose(world["toeplitz"], np.asarray(ref), rtol=REL)


def _cfjax_dryrun(n_devices):
    """The steps of cfjax's `dryrun_multichip`, returning their numbers."""
    from cfjax.kernels import EQ, MaternP
    from cfjax.parallel.mesh import shard_rows
    from cfjax.parallel.mesh import default_mesh as jdefault_mesh

    k = MaternP(2)
    rng = np.random.default_rng(0)
    mesh2d = jmesh2()
    n, d = 16 * n_devices, 3
    x = jnp.asarray(rng.standard_normal((n, d)))
    y = jnp.asarray(rng.standard_normal(n))
    mv = lambda v: j_matvec_2d(k, x, x, v, "iso", mesh2d, block=16) + 1e-4 * v
    alpha, (iters, _) = jcg(mv, y, tol=1e-8, maxiter=50)
    mean = j_matvec_2d(k, x, x, alpha, "iso", mesh2d, block=16)
    mesh1d = jdefault_mesh(n_devices)
    b = j_matvec(k, shard_rows(x, mesh1d), x, y, "iso", mesh1d, block=16)
    ng, dg = 8 * n_devices, 3
    xg = jnp.asarray(rng.standard_normal((ng, dg)))
    tg = jnp.asarray(rng.standard_normal(ng * dg))
    Gg = JShardedGradient(k, xg, mesh=mesh2d, row_axis="rows", col_axis="cols", block=8)
    alpha_g, (it_g, _) = jcg(lambda v: Gg @ v + 1e-3 * v, tg, tol=1e-6, maxiter=25)
    nb = 64 * n_devices
    xb = jnp.asarray(rng.standard_normal((nb, 2)))
    wb = jnp.asarray(rng.random(nb))
    bb = j_bh(JBarnesHut(EQ(), xb, theta=0.25, group_size=16), wb, mesh2d, axis="rows")
    np_pts = 32 * n_devices
    xp = jnp.asarray(rng.standard_normal((np_pts, 3)))
    yp = jnp.asarray(rng.standard_normal(np_pts))
    Mp = jnystrom(EQ(), xp, 1e-2, rank=16)
    mvp = lambda v: j_matvec_2d(EQ(), xp, xp, v, "iso", mesh2d, block=16) + 1e-2 * v
    ap, (it_p, _) = jcg(mvp, yp, tol=1e-8, maxiter=30, M=Mp)
    return dict(loss=jnp.mean((mean - y) ** 2), cg_iters=iters, alpha=alpha, mvm=b,
                grad_iters=it_g, grad_alpha=alpha_g, bh=bb, pcg_iters=it_p, pcg_alpha=ap)


def test_dryrun_multichip_matches_cfjax(world):
    got, ref = world["dryrun"], _cfjax_dryrun(4)
    # the products agree as every MVM here does
    for key in ("mvm", "bh"):
        np.testing.assert_allclose(got[key], np.asarray(ref[key]), rtol=REL, err_msg=key)
    # each CG of the dry run stops at its maxiter (50, 25 and 30 steps on
    # systems with condition numbers of 1e5 and more), short of its
    # tolerance: its iterate keeps every step's rounding, and the loss (a
    # residual of 5e-6) with it. Measured: the iterates 4e-5 of their norm
    # apart at most, the loss 3.8%.
    for key in ("cg_iters", "grad_iters", "pcg_iters"):
        assert int(got[key]) == int(ref[key]), key
    for key in ("alpha", "grad_alpha", "pcg_alpha"):
        r = np.asarray(ref[key])
        assert np.linalg.norm(got[key] - r) <= 1e-4 * np.linalg.norm(r), key
    np.testing.assert_allclose(got["loss"], float(ref["loss"]), rtol=0.1)


def test_init_distributed_single_rank(one_rank):
    mesh = init_distributed()   # nothing to coordinate: a one-rank group
    assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
    assert mesh.size() == 1 and mesh.mesh_dim_names == ("rows", "cols")
    assert len(mesh.mesh_dim_names) == mesh.ndim


def test_default_mesh_without_group(one_rank):
    mesh = default_mesh()
    assert dist.is_initialized() and mesh.mesh_dim_names == ("data",) and mesh.size() == 1
    with pytest.raises(ValueError):
        default_mesh(4)


def test_world_size_one_dense(one_rank, data):
    x, a = data["dense"]
    G = ShardedGramian(tk.MaternP(2), torch.from_numpy(x), block=16)
    ref = JShardedGramian(jk.MaternP(2), jnp.asarray(x), mesh=jmesh1(), block=16) @ jnp.asarray(a)
    np.testing.assert_allclose(G @ torch.from_numpy(a), np.asarray(ref), rtol=REL)
    assert G.x.shape[0] == 100 and G.kernel_reason is not None
