"""Device-mesh parallelism for lazy Gramians on `torch.distributed`
(counterpart of `cfjax.parallel.mesh`).

The model is SPMD: one process per GPU (a rank), every rank runs the same
program, and a `DeviceMesh` names the ranks' axes ("data", or "rows" and
"cols"). Row-block data parallelism, as in cfjax:

  - the points x are split along a mesh axis: each rank owns a row block
    of the implicit n x m kernel matrix and builds the local operator on
    it (`Gramian(k, x_block, y)`), so K1 or K2 take the shard on the card
    exactly as they take a whole matrix on one GPU;
  - y and the input vector are replicated;
  - the ranks' output blocks are all-gathered along the axis, so every
    public function returns the full result on every rank, identical
    across ranks;
  - CG runs the same iterations on every rank on replicated vectors
    (`sharded_cg`).

A 2-D mesh also splits the columns (y and the input vector) along a
second axis and sums the partial products over it. Named collectives over
the mesh's per-axis process groups (`mesh.get_group(axis)`) play the part
of shard_map's psum / psum_scatter: `_gather_rows`, `_psum` and
`_psum_scatter` below. Rows are padded so that every collective moves
blocks of one size; padded output rows are cut off. Both backends take
all three on CUDA tensors (gloo too, measured with torch 2.11 on an H100:
`chip_smoke.py` phase 24b), so none is staged through host memory.

The public functions take full tensors (or DTensors from `shard_rows` /
`replicate`) on every rank."""

from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..config import default_device
from ..operators.gramian import Gramian
from ..operators.linop import LinearOperator
from ..utils.grids import as_points


# --------------------------------------------------------------------------
# process groups and meshes
# --------------------------------------------------------------------------


def _backend(device: torch.device) -> str:
    """NCCL for the card, gloo for the CPU: chosen from the device."""
    return "nccl" if device.type == "cuda" else "gloo"


def _join(device: torch.device, coordinator_address=None, num_processes=None,
          process_id=None) -> None:
    """Join the default process group, unless one is initialised: through
    `tcp://coordinator_address`, else through `env://` where a launcher set
    `WORLD_SIZE` > 1 (torchrun), else as a single rank meeting through an
    in-memory store (nothing to coordinate, no environment needed). A CUDA
    rank first takes its card: the device's index, else `LOCAL_RANK`, else
    its rank modulo the node's cards."""
    if dist.is_initialized():
        return
    world = num_processes or int(os.environ.get("WORLD_SIZE", 1))
    rank = process_id if process_id is not None else int(os.environ.get("RANK", 0))
    if device.type == "cuda":
        torch.cuda.set_device(device.index if device.index is not None else int(
            os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count())))
    if coordinator_address is None and world <= 1:
        dist.init_process_group(_backend(device), store=dist.HashStore(), rank=0, world_size=1)
        return
    method = "env://" if coordinator_address is None else f"tcp://{coordinator_address}"
    dist.init_process_group(_backend(device), init_method=method, world_size=world, rank=rank)


def init_distributed(coordinator_address: str = None, num_processes: int = None,
                     process_id: int = None, mesh_shape: tuple = None,
                     axis_names: tuple = ("rows", "cols")) -> DeviceMesh:
    """Multi-process bring-up: join the default process group and build a
    2-D mesh over every rank.

    `coordinator_address` ("host:port" of rank 0), `num_processes` and
    `process_id` go to `init_process_group(init_method="tcp://...")`.
    Under a launcher that sets `WORLD_SIZE` > 1 (torchrun) they may be
    omitted: the group meets through `env://`. With nothing to coordinate
    (one process, no coordinator) the group is a single rank through an
    in-memory store. A group that is already initialised is used as it is.
    The backend follows the port's device (`config.DEFAULT.device`): NCCL
    for CUDA, gloo for the CPU.

    The default mesh shape follows cfjax's rule over hosts, where one rank
    is one GPU and a host is a node: rows = gcd(world size, nodes), nodes =
    world size // `LOCAL_WORLD_SIZE` (1 when that is unset); a single node
    with an even rank count takes 2 rows. Returns the `DeviceMesh`."""
    dev = default_device()
    _join(dev, coordinator_address, num_processes, process_id)
    if mesh_shape is None:
        nd = dist.get_world_size()
        nodes = nd // int(os.environ.get("LOCAL_WORLD_SIZE", nd))
        rows = math.gcd(nd, max(1, nodes))
        if rows == 1 and nd % 2 == 0 and nd > 1:
            rows = 2
        mesh_shape = (rows, nd // rows)
    axis_names = tuple(axis_names)[:len(mesh_shape)]
    return init_device_mesh(dev.type, tuple(mesh_shape), mesh_dim_names=axis_names)


def default_mesh(n_devices: int = None, axis: str = "data") -> DeviceMesh:
    """A 1-D mesh named `axis` over every rank of the default process
    group, joined first as `init_distributed` joins it (so one GPU with no
    launcher gets a one-rank group, no environment needed). `n_devices`,
    where given, must be the world size: a rank is one GPU, and a mesh
    over part of the world would leave ranks out of its collectives."""
    dev = default_device()
    _join(dev)
    nd = dist.get_world_size()
    if n_devices is not None and n_devices != nd:
        raise ValueError(f"default_mesh: {n_devices} devices asked for, the world has {nd} ranks")
    return init_device_mesh(dev.type, (nd,), mesh_dim_names=(axis,))


def _coord(mesh: DeviceMesh, axis: str):
    """(number of ranks along `axis`, this rank's index along it)."""
    return mesh.size(mesh.mesh_dim_names.index(axis)), mesh.get_local_rank(axis)


# --------------------------------------------------------------------------
# collectives over one mesh axis
# --------------------------------------------------------------------------


def _gather_rows(local, mesh: DeviceMesh, axis: str, n: int):
    """The rows of every rank's block along `axis`, in the axis' order,
    cut to the first n: the padded all-gather. Each block is padded with
    zero rows to ceil(n / ranks) first, so the collective moves equal
    sizes; blocks that fill those rows in order (a row split of an n-row
    array padded to a multiple, or torch.chunk's) concatenate to the
    array. gloo and NCCL both take the list form on CUDA tensors."""
    k, _ = _coord(mesh, axis)
    rows = -(-n // k)
    local = local.contiguous()
    if local.shape[0] < rows:
        local = torch.cat([local, local.new_zeros((rows - local.shape[0],) + local.shape[1:])])
    parts = [torch.empty_like(local) for _ in range(k)]
    dist.all_gather(parts, local, group=mesh.get_group(axis))
    return torch.cat(parts)[:n]


def _psum(t, mesh: DeviceMesh, axis: str):
    """The sum of `t` over the ranks along `axis`, on every one of them
    (in place)."""
    dist.all_reduce(t, group=mesh.get_group(axis))
    return t


def _psum_scatter(t, mesh: DeviceMesh, axis: str):
    """This rank's row block of the sum of `t` over the ranks along
    `axis` (rows divisible by the rank count): the reduce-scatter."""
    k, _ = _coord(mesh, axis)
    parts = [p.contiguous() for p in t.chunk(k)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=mesh.get_group(axis))
    return out


# --------------------------------------------------------------------------
# placement
# --------------------------------------------------------------------------


def _pad_rows_zero(arr, mult: int):
    p = (-arr.shape[0]) % mult
    if not p:
        return arr
    return torch.cat([arr, arr.new_zeros((p,) + tuple(arr.shape[1:]))])


def _row_block(arr, k: int, me: int):
    """Block `me` of `k` equal row blocks of `arr` (rows divisible by k)."""
    c = arr.shape[0] // k
    return arr[me * c:(me + 1) * c]


def shard_rows(arr, mesh: DeviceMesh, axis: str = "data"):
    """An (n, ...) tensor as a DTensor split by rows along `axis`
    (`Shard(0)`; replicated along any other axis), the counterpart of a
    row-sharded `NamedSharding`. Every rank passes the same full tensor
    and keeps its `torch.chunk` block; nothing is communicated."""
    arr = torch.as_tensor(arr, device=mesh.device_type)
    k, me = _coord(mesh, axis)
    chunks = arr.chunk(k)
    local = chunks[me] if me < len(chunks) else arr[:0]
    placements = [Shard(0) if name == axis else Replicate() for name in mesh.mesh_dim_names]
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=arr.shape,
                              stride=arr.stride())


def replicate(arr, mesh: DeviceMesh):
    """A tensor as a DTensor replicated over the mesh (each rank keeps
    its own copy; nothing is communicated)."""
    arr = torch.as_tensor(arr, device=mesh.device_type)
    return DTensor.from_local(arr, mesh, [Replicate()] * mesh.ndim, run_check=False)


def _global(t):
    """The full tensor behind `t`: a plain tensor as it is, a DTensor from
    `shard_rows` / `replicate` by the padded all-gather of its blocks."""
    if not isinstance(t, DTensor):
        return t
    local = t.to_local()
    for name, p in zip(t.device_mesh.mesh_dim_names, t.placements):
        if isinstance(p, Shard):
            if p.dim != 0:
                raise ValueError(f"only row-sharded DTensors are taken, not {p}")
            local = _gather_rows(local, t.device_mesh, name, t.shape[0])
        elif not isinstance(p, Replicate):
            raise ValueError(f"unsupported placement {p}")
    return local


# --------------------------------------------------------------------------
# the sharded dense Gramian
# --------------------------------------------------------------------------


def _local_gramian(k, x_block, y, mode, block):
    G = Gramian(k, x_block, y, block=block)
    if mode is not None and mode != G.mode:
        raise ValueError(f"mode {mode!r}: the kernel's trait gives {G.mode!r}")
    return G


def sharded_gramian_matvec(k, x, y, a, mode: str, mesh: DeviceMesh, axis: str = "data",
                           block: int = 512):
    """b = K a with the rows of K split over `axis`: each rank pads x with
    zero rows to a multiple of the rank count, builds the Gramian of its
    row block against all of y (K1 / K2 on float32 CUDA tensors, the
    blocked plain product otherwise) and the blocks are all-gathered."""
    xp = as_points(_global(x))
    yp = as_points(_global(y))
    nd, me = _coord(mesh, axis)
    G = _local_gramian(k, _row_block(_pad_rows_zero(xp, nd), nd, me), yp, mode, block)
    a = torch.as_tensor(_global(a), device=G.device)
    return _gather_rows(G._matvec(a), mesh, axis, xp.shape[0])


def sharded_gramian_matvec_2d(k, x, y, a, mode: str, mesh: DeviceMesh, row_axis: str = "rows",
                              col_axis: str = "cols", block: int = 512):
    """b = K a over a 2-D mesh: rows of K split on `row_axis`, columns (y
    and the input vector, zero-padded) on `col_axis`. Each rank builds
    the Gramian of its (row block x column block) tile, its partial
    product is summed over the column axis and the row blocks are
    all-gathered (this domain's dp x tp decomposition)."""
    xp = as_points(_global(x))
    yp = as_points(_global(y))
    nr, r = _coord(mesh, row_axis)
    nc, c = _coord(mesh, col_axis)
    G = _local_gramian(k, _row_block(_pad_rows_zero(xp, nr), nr, r),
                       _row_block(_pad_rows_zero(yp, nc), nc, c), mode, block)
    a = torch.as_tensor(_global(a), device=G.device)
    part = G._matvec(_row_block(_pad_rows_zero(a, nc), nc, c))
    return _gather_rows(_psum(part, mesh, col_axis), mesh, row_axis, xp.shape[0])


def sharded_cg(matvec, b, tol: float = 1e-8, maxiter: int = 1000, M=None):
    """CG fed by a sharded matvec: `cfjax_torch.operators.solvers.cg` on
    replicated vectors. Every rank gets the same all-gathered products,
    so every rank runs the same iterations to the same solution."""
    from ..operators.solvers import cg

    return cg(matvec, _global(b), tol=tol, maxiter=maxiter, M=M)


class ShardedGramian(LinearOperator):
    """Row-sharded lazy Gramian over a device mesh: this rank's row block
    of x (`self.x`) against all of y (`self.y`), as the local `Gramian`
    `self.local`, whose kernel choice `kernel` / `kernel_reason` report."""

    def __init__(self, k, x, y=None, mesh: DeviceMesh = None, axis: str = "data",
                 block: int = 512):
        self.k = k
        self.mesh = mesh if mesh is not None else default_mesh()
        self.axis = axis
        xp = as_points(_global(x))
        yp = xp if y is None else as_points(_global(y))
        self._same = y is None
        nd, me = _coord(self.mesh, axis)
        self._n = xp.shape[0]
        self.x = _row_block(_pad_rows_zero(xp, nd), nd, me)
        self.y = yp
        self.local = Gramian(k, self.x, yp, block=block)
        self.shape = (xp.shape[0], yp.shape[0])
        self.dtype = self.local.dtype
        self.device = self.local.device
        self.mode = self.local.mode
        self.block = block

    @property
    def kernel(self):
        return self.local.kernel

    @property
    def kernel_reason(self):
        return self.local.kernel_reason

    @property
    def is_symmetric(self):
        return self._same

    @property
    def is_psd(self):
        return self._same and self.k.is_mercer

    def _matvec(self, v):
        return _gather_rows(self.local._matvec(v), self.mesh, self.axis, self._n)

    def solve(self, b, tol: float = 1e-8, maxiter: int = 1000, **kw):
        x, _ = sharded_cg(self._matvec, b, tol=tol, maxiter=maxiter)
        return x
