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
world size.  `devices=`, the JAX spelling, lists the group's global ranks
in the mesh's order (one card a rank), and must hold each of them once.

Axis names.  In the JAX package `psum_axis="row"` (`ops.qr`) names an axis
that `shard_map` binds while the sharded body runs.  Here `bind_mesh(mesh)`
binds a mesh for the duration of a `with` block: inside it, `psum(x,
"row")` and `pmax(x, "row")` reduce over that mesh dimension's process
group, and `ops.qr`'s `psum_axis=` goes through them.  `row_sharded_qr`
binds its own mesh; an axis name that no bound mesh has raises.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def _make_mesh(shape, names, device_type: str, devices=None):
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
    ranks = list(range(world)) if devices is None else [int(d) for d in devices]
    if sorted(ranks) != list(range(world)):
        raise ValueError(f"devices {ranks}: a mesh spans the whole process group, "
                         f"so it lists each of the ranks 0..{world - 1} once")
    if device_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(tuple(shape)),
                      mesh_dim_names=tuple(names))


def node_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence[int]] = None,
              device_type: str = "cuda"):
    """1-D mesh over the contour-node axis, dimension name "node".

    devices: global ranks in mesh order (default: rank order); n_devices
    keeps the first n_devices of them.  Either way the mesh must cover the
    whole process group."""
    if devices is not None:
        devices = list(devices)[:n_devices]
        n_devices = len(devices)
    elif n_devices is None:
        n_devices = dist.get_world_size() if dist.is_initialized() else 0
    return _make_mesh((n_devices,), ("node",), device_type, devices)


def node_row_mesh(n_node: int, n_row: int, devices: Optional[Sequence[int]] = None,
                  device_type: str = "cuda"):
    """2-D mesh: n_node node groups of n_row matrix-row shards, dimension
    names ("node", "row").  devices: global ranks in mesh order, row-major
    (default: rank order); the first n_node * n_row are used."""
    if devices is not None:
        devices = list(devices)[:n_node * n_row]
    return _make_mesh((n_node, n_row), ("node", "row"), device_type, devices)


def mesh_device(mesh, device=None) -> torch.device:
    """This rank's device on `mesh`; `device`, when given, must be of the
    mesh's type."""
    if device is not None and torch.device(device).type != mesh.device_type:
        raise ValueError(f"device={device!r} on a {mesh.device_type!r} mesh")
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _dim_line(mesh, dim: str):
    """The global ranks of this rank's line along `dim`, in mesh order.
    (The dimension's process group numbers them in ascending global rank,
    which is the mesh order only where `devices` kept the rank order.)"""
    if dim not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh {mesh.mesh_dim_names} has no {dim!r} dimension")
    at = list(mesh.get_coordinate())
    at[mesh.mesh_dim_names.index(dim)] = slice(None)
    return mesh.mesh[tuple(at)].tolist()


def _dim_rank(mesh, dim: str):
    """(this rank's position along `dim` in mesh order, the dimension's size)."""
    line = _dim_line(mesh, dim)
    return line.index(dist.get_rank()), len(line)


def _block(x: torch.Tensor, mesh, dim: str) -> torch.Tensor:
    k, size = _dim_rank(mesh, dim)
    if x.shape[0] % size:
        raise ValueError(f"leading axis {x.shape[0]} not divisible by the "
                         f"{dim!r} dimension's {size} ranks")
    step = x.shape[0] // size
    return x[k * step:(k + 1) * step].to(mesh_device(mesh))


def _tree_map(fn, tree):
    """fn on every leaf of a pytree: a tensor (or an array or number, taken
    as a tensor), or a tuple, list, dict or NamedTuple of them, nested;
    None stays None.  The same structure comes back."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return type(tree)((k, _tree_map(fn, v)) for k, v in tree.items())
    return fn(tree if isinstance(tree, torch.Tensor) else torch.as_tensor(tree))


def shard_nodes(tree, mesh):
    """This rank's block of each node-leading tensor of a pytree (leading
    axis split over "node"), on the rank's device."""
    return _tree_map(lambda x: _block(x, mesh, "node"), tree)


def shard_rows(tree, mesh):
    """This rank's block of the first (row) axis of each tensor of a
    pytree, split over "row"."""
    return _tree_map(lambda x: _block(x, mesh, "row"), tree)


def _planes(x: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(x) if x.is_complex() else x


def replicate(tree, mesh):
    """Each tensor of a pytree as rank 0 of the mesh holds it, on every
    rank's device, in new tensors (the caller's are left as they were)."""
    def place(x):
        y = x.to(mesh_device(mesh)).contiguous()
        if y is x:
            y = x.clone()
        dist.broadcast(_planes(y), src=int(mesh.mesh.flatten()[0]))
        return y

    return _tree_map(place, tree)


def agree(tensors, mesh):
    """The tensors as rank 0 of the mesh computed them.  Every rank repeats
    the replicated phases (the Rayleigh-Ritz), but a sparse product that
    accumulates with atomics (CSR, the spill of BELL) rounds differently on
    each card, and ranks whose Ritz pairs differ in the last bit can order
    or phase them differently: the moment sum would then mix unrelated
    columns.  One broadcast of the phase's results keeps the ranks on one
    subspace."""
    return replicate(list(tensors), mesh)


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(_planes(out), op=op, group=group)
    return out


def all_reduce(x: torch.Tensor, mesh, dim: str) -> torch.Tensor:
    """Sum of x over the ranks of one mesh dimension (a new tensor)."""
    return _all_reduce(x, mesh.get_group(dim))


def node_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The moment accumulation: x summed over "node"."""
    return all_reduce(x, mesh, "node")


def node_sum_(x: torch.Tensor, mesh) -> torch.Tensor:
    """`node_sum` in place, into x (contiguous): the same sum, bit for bit,
    without the copy."""
    dist.all_reduce(_planes(x), group=mesh.get_group("node"))
    return x


def all_gather(x: torch.Tensor, mesh, dim: str) -> torch.Tensor:
    """The blocks x of the ranks of one mesh dimension, concatenated in mesh
    order along the leading axis.  Every gather of the parallel layer goes
    through here (the tests count the elements it moves)."""
    line, group = _dim_line(mesh, dim), mesh.get_group(dim)
    x = x.contiguous()
    parts = [torch.empty_like(_planes(x)) for _ in line]
    dist.all_gather(parts, _planes(x), group=group)
    out = torch.cat([parts[dist.get_group_rank(group, g)] for g in line])
    return torch.view_as_complex(out) if x.is_complex() else out


def gather_nodes(x: torch.Tensor, mesh) -> torch.Tensor:
    """Node-leading blocks of every "node" rank, in node order."""
    return all_gather(x, mesh, "node")


_BOUND = []     # the meshes of the enclosing bind_mesh blocks, innermost last


@contextlib.contextmanager
def bind_mesh(mesh):
    """Bind `mesh`'s dimension names for the `with` block, as `shard_map`
    binds its mesh's axis names in the JAX package: inside, `psum_axis=`
    of `ops.qr` (and `psum` / `pmax` here) may name its dimensions."""
    _BOUND.append(mesh)
    try:
        yield mesh
    finally:
        _BOUND.pop()


def _reduce(x: torch.Tensor, axis, op) -> torch.Tensor:
    """x reduced with `op` over the bound mesh dimension `axis` (a name, or
    a tuple of names, each reduced in turn)."""
    for name in (axis,) if isinstance(axis, str) else tuple(axis):
        mesh = next((m for m in reversed(_BOUND) if name in (m.mesh_dim_names or ())),
                    None)
        if mesh is None:
            raise ValueError(f"axis {name!r} names no dimension of a bound mesh; "
                             "run the call inside `with parallel.mesh.bind_mesh(mesh):`")
        x = _all_reduce(x, mesh.get_group(name), op)
    return x


def psum(x: torch.Tensor, axis) -> torch.Tensor:
    """Sum of x over the ranks of a bound mesh dimension (`lax.psum`)."""
    return _reduce(x, axis, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, axis) -> torch.Tensor:
    """Elementwise max of a real x over a bound mesh dimension
    (`lax.pmax`)."""
    if x.is_complex():
        raise TypeError("pmax of a complex tensor")
    return _reduce(x, axis, dist.ReduceOp.MAX)


def row_sharded_qr(A: torch.Tensor, mesh, method: str = "cholqr2"):
    """Tall-skinny QR with rows sharded over the mesh's "row" dimension.

    A is the full (n, m) matrix (the same on every rank); each rank keeps
    its (n / rows, m) block, and the only communication is one m x m
    all-reduce of the Gram per CholeskyQR pass (the TSQR pattern).
    Returns (Q, this rank's row block; R, the same on every rank)."""
    from ..ops import qr as qrmod

    fn = {"cholqr2": qrmod.cholqr2, "cholqr3": qrmod.cholqr3}[method]
    with bind_mesh(mesh):
        return fn(shard_rows(A, mesh), psum_axis="row")
