"""Rank side of tests/test_torch_parallel.py: every case of the parallel
layer, run on each rank of one spawned 4-rank gloo world on the CPU
(`cfjax_torch.utils.testing.run_world`). This module imports no jax: each
rank imports it anew. The inputs are the numpy arrays the test module
feeds cfjax too; rank 0's results go back to it."""

import numpy as np
import torch
import torch.distributed as dist

import cfjax_torch.kernels as tk
from cfjax_torch.barneshut import BarnesHutFactorization
from cfjax_torch.derivative import gradient as g
from cfjax_torch.operators.kronecker import KroneckerOperator
from cfjax_torch.operators.preconditioner import nystrom_preconditioner
from cfjax_torch.operators.solvers import cg
from cfjax_torch.operators.toeplitz import ToeplitzOperator
from cfjax_torch.parallel import (
    ShardedGradientGramian,
    ShardedGramian,
    ShardedHessianGramian,
    ShardedValueGradientGramian,
    default_mesh,
    init_distributed,
    replicate,
    shard_rows,
    sharded_bh_matvec,
    sharded_block_apply,
    sharded_cg,
    sharded_gramian_matvec,
    sharded_kronecker_matvec,
    sharded_toeplitz_matmat,
)
from cfjax_torch.parallel.dryrun import dryrun_multichip
from cfjax_torch.parallel.mesh import sharded_gramian_matvec_2d

GRAD_KERNELS = {"MaternP2": lambda: tk.MaternP(2), "Dot2": lambda: tk.Dot() ** 2}


def every_rank(t):
    """t from every rank of the world, stacked in rank order."""
    t = torch.as_tensor(t).reshape(1, -1).double()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return torch.cat(parts)


def world_cases(data):
    """Every case on this rank: {case: result}. `data` maps each case to
    its numpy inputs."""
    T = lambda a: torch.from_numpy(np.asarray(a))
    mesh = default_mesh()
    mesh2 = init_distributed()
    out = {"world": dist.get_world_size(), "mesh2_shape": tuple(mesh2.mesh.shape),
           "mesh2_names": tuple(mesh2.mesh_dim_names), "mesh_names": tuple(mesh.mesh_dim_names)}

    x, a = map(T, data["dense"])
    G = ShardedGramian(tk.MaternP(2), x, mesh=mesh, block=16)
    out["dense"] = G @ a
    out["dense_shard_rows"] = G.x.shape[0]

    x, a = map(T, data["uneven"])
    out["uneven"] = sharded_gramian_matvec(tk.EQ(), x, x, a, "iso", mesh, block=16)
    out["uneven_dtensor"] = sharded_gramian_matvec(
        tk.EQ(), shard_rows(x, mesh), replicate(x, mesh), replicate(a, mesh), "iso", mesh,
        block=16)

    x, a = map(T, data["solve"])
    op = ShardedGramian(tk.EQ(), x, mesh=mesh, block=16).add_diagonal(1e-4)
    xs, (it, _) = sharded_cg(op._matvec, a, tol=1e-12, maxiter=500)
    out["solve"] = xs
    out["solve_ranks"] = every_rank(xs)
    out["solve_iters_ranks"] = every_rank(torch.tensor([it]))

    x, y = map(T, data["pcg2d"])
    k = tk.Lengthscale(tk.EQ(), 1.0)
    M = nystrom_preconditioner(k, x, 1e-2, rank=64)
    mv = lambda v: sharded_gramian_matvec_2d(k, x, x, v, "iso", mesh2, block=64) + 1e-2 * v
    a2, (it2, _) = cg(mv, y, tol=1e-10, maxiter=200, M=M)
    out["pcg2d"], out["pcg2d_iters"] = a2, it2
    out["pcg2d_ranks"] = every_rank(a2)
    out["pcg2d_iters_ranks"] = every_rank(torch.tensor([it2]))

    for name, make in GRAD_KERNELS.items():
        x, v = map(T, data["grad"])
        out[f"grad_{name}"] = ShardedGradientGramian(make(), x, mesh=mesh, block=8) @ v
    x, v = map(T, data["grad_2d"])
    G2 = ShardedGradientGramian(tk.EQ(), x, mesh=mesh2, row_axis="rows", col_axis="cols",
                                block=8)
    out["grad_2d"] = G2 @ v
    out["grad_2d_reason"] = G2.kernel_reason
    out["block_apply_2d"] = sharded_block_apply(
        g.grad_matvec_iso, tk.EQ(), x, x, (v.reshape(x.shape[0], -1),), mesh2, "rows", "cols",
        block=8)

    x, v = map(T, data["valgrad"])
    out["valgrad"] = ShardedValueGradientGramian(tk.RQ(1.5), x, mesh=mesh, block=8) @ v
    x, v = map(T, data["hessian"])
    out["hessian"] = ShardedHessianGramian(tk.EQ(), x, mesh=mesh, block=4) @ v

    x, w = map(T, data["bh"])
    F = BarnesHutFactorization(tk.EQ(), x, theta=0.25, group_size=16)
    out["bh"] = sharded_bh_matvec(F, w, mesh)
    out["bh_single"] = F @ w

    *mats, a = map(T, data["kron"])
    K = KroneckerOperator(mats)
    out["kron"] = sharded_kronecker_matvec(K, a, mesh)

    col, V = map(T, data["toeplitz"])
    out["toeplitz"] = sharded_toeplitz_matmat(ToeplitzOperator(col), V, mesh)

    out["dryrun"] = dryrun_multichip(4, dtype=torch.float64)
    return out


def shard_kernels():
    """On each rank of a world sharing the card: the kernel choice of the
    1-D dense and the 2-D gradient shards, the launches of those and of the
    2-D dense product (K1 twice, K3 once), and the products' errors
    against the single-GPU operators."""
    from cfjax_torch.derivative import GradientKernel
    from cfjax_torch.operators.dispatch import gramian
    from cfjax_torch.ops import gramian_mvm as mvm

    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal((2000, 3)), dtype=torch.float32, device="cuda")
    a = torch.tensor(rng.standard_normal(2000), dtype=torch.float32, device="cuda")
    xg = torch.tensor(0.5 * rng.standard_normal((500, 16)), dtype=torch.float32, device="cuda")
    A = torch.tensor(rng.standard_normal(500 * 16), dtype=torch.float32, device="cuda")
    mesh, mesh2 = default_mesh(), init_distributed()
    G = ShardedGramian(tk.MaternP(2), x, mesh=mesh)
    Gg = ShardedGradientGramian(tk.EQ(), xg, mesh=mesh2, row_axis="rows", col_axis="cols")
    b1, b2, bg = G @ a, sharded_gramian_matvec_2d(tk.MaternP(2), x, x, a, "iso", mesh2), Gg @ A
    launches = dict(mvm.LAUNCHES)
    reasons = [G.kernel_reason, Gg.kernel_reason]
    ref = gramian(tk.MaternP(2), x.double()) @ a.double()
    refg = gramian(GradientKernel(tk.EQ()), xg.double()) @ A.double()
    rel = lambda u, r: float(torch.linalg.norm(u.double() - r) / torch.linalg.norm(r))
    mine = {"reasons": reasons, "launches": launches}
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, mine)
    return {"ranks": ranks, "errors": [rel(b1, ref), rel(b2, ref), rel(bg, refg)]}
