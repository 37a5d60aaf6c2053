"""Device-mesh parallelism for the contour solvers on `torch.distributed`.

Counterpart of `feast_tpu/parallel/mesh.py`.  The quadrature-node axis is a
mesh dimension: each rank holds nodes / ranks of the contour nodes, factors
and solves them, and one all-reduce over "node" sums the moment block.  A
second "row" dimension shards the matrix rows (`rowsharded.py`), and a
"slice" dimension spreads spectral slices (`slicing.py`).

The JAX package has one controller that places arrays on devices; here
every rank runs the same program on its own block (SPMD), so the mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the process group the
caller already initialized (under `torch.multiprocessing.spawn` or
`torchrun`), and collectives are explicit.  A "cuda" mesh needs the NCCL
backend and puts each rank's tensors on `cuda:<local rank>`; a "cpu" mesh
needs gloo.  Nothing falls back from one to the other.  Complex tensors
cross the wire as their `torch.view_as_real` planes.

A mesh spans the whole process group: `node_mesh(n)` and
`node_row_mesh(n_node, n_row)` raise unless the sizes multiply to the
world size.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def _make_mesh(shape, names, device_type: str):
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("feast_tpu_torch.parallel: initialize the process group "
                           "first (torch.distributed.init_process_group)")
    if device_type not in _BACKEND:
        raise ValueError(f"device_type {device_type!r} (cuda|cpu)")
    backend = str(dist.get_backend())
    if _BACKEND[device_type] not in backend:
        raise RuntimeError(f"a {device_type!r} mesh needs the {_BACKEND[device_type]} "
                           f"backend; the process group runs {backend!r}")
    world = dist.get_world_size()
    size = 1
    for s in shape:
        size *= int(s)
    if size != world:
        raise ValueError(f"mesh {dict(zip(names, shape))} has {size} ranks, the "
                         f"process group {world}")
    if device_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    return DeviceMesh(device_type, torch.arange(world).reshape(tuple(shape)),
                      mesh_dim_names=tuple(names))


def node_mesh(n: Optional[int] = None, device_type: str = "cuda"):
    """1-D mesh over the contour-node axis, dimension name "node"."""
    world = dist.get_world_size() if dist.is_initialized() else 0
    return _make_mesh((world if n is None else n,), ("node",), device_type)


def node_row_mesh(n_node: int, n_row: int, device_type: str = "cuda"):
    """2-D mesh: n_node node groups of n_row matrix-row shards, dimension
    names ("node", "row")."""
    return _make_mesh((n_node, n_row), ("node", "row"), device_type)


def mesh_device(mesh, device=None) -> torch.device:
    """This rank's device on `mesh`; `device`, when given, must be of the
    mesh's type."""
    if device is not None and torch.device(device).type != mesh.device_type:
        raise ValueError(f"device={device!r} on a {mesh.device_type!r} mesh")
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _dim_rank(mesh, dim: str):
    if dim not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh {mesh.mesh_dim_names} has no {dim!r} dimension")
    return mesh.get_local_rank(dim), mesh.size(mesh.mesh_dim_names.index(dim))


def _block(x: torch.Tensor, mesh, dim: str) -> torch.Tensor:
    k, size = _dim_rank(mesh, dim)
    if x.shape[0] % size:
        raise ValueError(f"leading axis {x.shape[0]} not divisible by the "
                         f"{dim!r} dimension's {size} ranks")
    step = x.shape[0] // size
    return x[k * step:(k + 1) * step].to(mesh_device(mesh))


def shard_nodes(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's block of a node-leading tensor (leading axis split over
    "node"), on the rank's device."""
    return _block(x, mesh, "node")


def shard_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's block of the first (row) axis split over "row"."""
    return _block(x, mesh, "row")


def _planes(x: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(x) if x.is_complex() else x


def replicate(x: torch.Tensor, mesh) -> torch.Tensor:
    """x as rank 0 of the mesh holds it, on every rank's device."""
    x = x.to(mesh_device(mesh)).contiguous()
    dist.broadcast(_planes(x), src=int(mesh.mesh.flatten()[0]))
    return x


def agree(tensors, mesh):
    """The tensors as rank 0 of the mesh computed them.  Every rank repeats
    the replicated phases (the Rayleigh-Ritz), but a sparse product that
    accumulates with atomics (CSR, the spill of BELL) rounds differently on
    each card, and ranks whose Ritz pairs differ in the last bit can order
    or phase them differently: the moment sum would then mix unrelated
    columns.  One broadcast of the phase's results keeps the ranks on one
    subspace."""
    return [replicate(t, mesh) for t in tensors]


def all_reduce(x: torch.Tensor, mesh, dim: str) -> torch.Tensor:
    """Sum of x over the ranks of one mesh dimension (a new tensor)."""
    out = x.contiguous().clone()
    dist.all_reduce(_planes(out), group=mesh.get_group(dim))
    return out


def node_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The moment accumulation: x summed over "node"."""
    return all_reduce(x, mesh, "node")


def all_gather(x: torch.Tensor, mesh, dim: str) -> torch.Tensor:
    """The blocks x of the ranks of one mesh dimension, concatenated in rank
    order along the leading axis.  Every gather of the parallel layer goes
    through here (the tests count the elements it moves)."""
    _, size = _dim_rank(mesh, dim)
    x = x.contiguous()
    parts = [torch.empty_like(_planes(x)) for _ in range(size)]
    dist.all_gather(parts, _planes(x), group=mesh.get_group(dim))
    out = torch.cat(parts)
    return torch.view_as_complex(out) if x.is_complex() else out


def gather_nodes(x: torch.Tensor, mesh) -> torch.Tensor:
    """Node-leading blocks of every "node" rank, in node order."""
    return all_gather(x, mesh, "node")


def row_sharded_qr(A: torch.Tensor, mesh, method: str = "cholqr2"):
    """Tall-skinny QR with rows sharded over the mesh's "row" dimension.

    A is the full (n, m) matrix (the same on every rank); each rank keeps
    its (n / rows, m) block, and the only communication is one m x m
    all-reduce of the Gram per CholeskyQR pass (the TSQR pattern).
    Returns (Q, this rank's row block; R, the same on every rank)."""
    from ..ops import qr as qrmod

    fn = {"cholqr2": qrmod.cholqr2, "cholqr3": qrmod.cholqr3}[method]
    return fn(shard_rows(A, mesh), reduce=lambda G: all_reduce(G, mesh, "row"))
