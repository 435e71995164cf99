"""The multi-rank dry run: one sharded GP training step and the structured
fast paths over a 2-D mesh of every rank (counterpart of cfjax's
`__graft_entry__.dryrun_multichip`).

Run it on every rank of an initialised process group: it builds its
meshes over the group and returns the numbers of each step, the same on
every rank."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..config import default_device


def _mesh_rows(n: int) -> int:
    """The largest divisor of n at most sqrt(n): the 2-D mesh's rows (1
    for a prime count, a 1 x n mesh)."""
    return next(c for c in range(int(n ** 0.5), 0, -1) if n % c == 0)


def dryrun_multichip(n_ranks: int, dtype=torch.float32) -> dict:
    """The sharded GP training step and the structured paths at cfjax's dry
    run sizes, on `n_ranks` ranks (the world size), with points and vectors
    drawn from `np.random.default_rng(0)` in cfjax's order, as `dtype` on
    the port's device:

      * the GP-CG training step over the 2-D ("rows", "cols") mesh:
        MaternP(2), n = 16 n_ranks, d = 3, CG on K + 1e-4 I (tol 1e-8, 50
        iterations at most), the posterior mean at the points, the loss
        (mean squared error against the targets);
      * the 1-D row-sharded MVM, x placed with `shard_rows`;
      * the gradient-gramian CG, n = 8 n_ranks, d = 3, rows on "rows" and
        the source points' column sum on "cols" (tol 1e-6, 25 iterations);
      * the Barnes-Hut MVM (EQ, n = 64 n_ranks, d = 2, theta 1/4, groups of
        16) with its target groups split over "rows";
      * the Nystrom-PCG step (EQ, n = 32 n_ranks, d = 3, rank 16, noise
        1e-2, tol 1e-8, 30 iterations) on the 2-D sharded MVM.

    Returns the loss, the iteration counts and the steps' outputs. Raises
    where an output is not finite."""
    from ..barneshut import BarnesHutFactorization
    from ..kernels import EQ, MaternP
    from ..operators.preconditioner import nystrom_preconditioner
    from ..operators.solvers import cg
    from .mesh import default_mesh, shard_rows, sharded_gramian_matvec, sharded_gramian_matvec_2d
    from .structured import ShardedGradientGramian, sharded_bh_matvec

    if dist.get_world_size() != n_ranks:
        raise ValueError(f"dryrun_multichip({n_ranks}) in a world of {dist.get_world_size()} ranks")
    dev = default_device()
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    k = MaternP(2)
    rng = np.random.default_rng(0)
    nr = _mesh_rows(n_ranks)
    nc = n_ranks // nr
    mesh2d = init_device_mesh(dev.type, (nr, nc), mesh_dim_names=("rows", "cols"))

    n, d = 16 * n_ranks, 3
    x = t(rng.standard_normal((n, d)))
    y = t(rng.standard_normal(n))
    mv = lambda v: sharded_gramian_matvec_2d(k, x, x, v, "iso", mesh2d, block=16) + 1e-4 * v
    alpha, (iters, _) = cg(mv, y, tol=1e-8, maxiter=50)
    mean = sharded_gramian_matvec_2d(k, x, x, alpha, "iso", mesh2d, block=16)
    loss = torch.mean((mean - y) ** 2)

    mesh1d = default_mesh(n_ranks)
    b = sharded_gramian_matvec(k, shard_rows(x, mesh1d), x, y, "iso", mesh1d, block=16)

    ng, dg = 8 * n_ranks, 3
    xg = t(rng.standard_normal((ng, dg)))
    tg = t(rng.standard_normal(ng * dg))
    Gg = ShardedGradientGramian(k, xg, mesh=mesh2d, row_axis="rows",
                                col_axis="cols" if nc > 1 else None, block=8)
    alpha_g, (it_g, _) = cg(lambda v: Gg @ v + 1e-3 * v, tg, tol=1e-6, maxiter=25)

    nb = 64 * n_ranks
    xb = t(rng.standard_normal((nb, 2)))
    wb = t(rng.random(nb))
    F = BarnesHutFactorization(EQ(), xb, theta=0.25, group_size=16)
    bb = sharded_bh_matvec(F, wb, mesh2d, axis="rows")

    kp = EQ()
    np_pts = 32 * n_ranks
    xp = t(rng.standard_normal((np_pts, 3)))
    yp = t(rng.standard_normal(np_pts))
    Mp = nystrom_preconditioner(kp, xp, 1e-2, rank=16)
    mvp = lambda v: sharded_gramian_matvec_2d(kp, xp, xp, v, "iso", mesh2d, block=16) + 1e-2 * v
    ap, (it_p, _) = cg(mvp, yp, tol=1e-8, maxiter=30, M=Mp)

    out = dict(loss=loss, cg_iters=iters, alpha=alpha, mvm=b, grad_iters=it_g, grad_alpha=alpha_g,
               bh=bb, pcg_iters=it_p, pcg_alpha=ap)
    for key, v in out.items():
        if isinstance(v, torch.Tensor) and not bool(torch.isfinite(v).all()):
            raise FloatingPointError(f"dryrun_multichip: {key} is not finite")
    return out
