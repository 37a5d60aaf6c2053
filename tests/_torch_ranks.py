"""Gloo (or, on a machine with several cards, NCCL) ranks for the port's
parallel tests.

A `Ranks` group is spawned once per test module and runs one named case at
a time on every rank (SPMD), each rank returning numpy results.  This
module imports torch and the port only, never jax, so the spawned ranks do
not pay the JAX package's import; the ranks rendezvous on a FileStore, so
no port is opened.  Each rank runs one thread: several test files run side
by side, and their ranks would oversubscribe the cores.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import traceback
from typing import NamedTuple

import numpy as np
import torch

CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def _serve(rank, world, store_path, inbox, outbox, backend="gloo"):
    import torch.distributed as dist

    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=90))
    try:
        while (msg := inbox.get()) is not None:
            name, kw = msg
            try:
                outbox.put((rank, True, CASES[name](**kw)))
            except Exception:   # reported to the test, which raises it
                outbox.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class Ranks:
    """`world` spawned ranks serving `CASES`: gloo, or with backend "nccl"
    one card a rank."""

    def __init__(self, world: int, tmpdir: str, backend: str = "gloo"):
        ctx = multiprocessing.get_context("spawn")
        self.world = world
        self.inboxes = [ctx.Queue() for _ in range(world)]
        self.outbox = ctx.Queue()
        store = os.path.join(tmpdir, "store")
        self.procs = [ctx.Process(target=_serve, daemon=True,
                                  args=(r, world, store, self.inboxes[r], self.outbox,
                                        backend))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def run(self, name: str, timeout: float = 240.0, **kw):
        """Per-rank results of CASES[name](**kw), in rank order."""
        for q in self.inboxes:
            q.put((name, kw))
        out, failed = [None] * self.world, []
        for _ in range(self.world):       # every answer, so none is left queued
            try:
                rank, ok, val = self.outbox.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(f"{name}: no answer from the ranks in {timeout} s")
            out[rank] = val
            if not ok:
                failed.append(f"{name} failed on rank {rank}:\n{val}")
        if failed:
            raise RuntimeError(failed[0])
        return out

    def close(self):
        for q in self.inboxes:
            q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()


# ---------------------------------------------------------------------------
# cases (run on every rank; arguments and results are numpy)
# ---------------------------------------------------------------------------

def _host(res):
    return {"lam": res.lam.numpy(), "X": res.X.numpy(), "res": res.res.numpy(),
            "inside": res.inside.numpy(), "n_iter": res.n_iter,
            "converged": res.converged}


@case
def world_info():
    import torch.distributed as dist

    return dist.get_rank(), dist.get_world_size()


@case
def dense_driver(driver, A, X0, B=None, Xl0=None, mesh_nodes=None, **kw):
    """feast / gen_feast / feast_compiled / dual_gen_feast with mesh=, and
    K1's batch on this rank (the node matrices it factors)."""
    import importlib

    import feast_tpu_torch as ft

    fmod = importlib.import_module("feast_tpu_torch.solvers.feast")
    batches = []
    factor_scan = fmod._factor_scan

    def counted(A_, B_, z, solve_f32):
        batches.append(int(z.shape[0]))
        return factor_scan(A_, B_, z, solve_f32)

    fmod._factor_scan = counted
    try:
        mesh = ft.parallel.node_mesh(mesh_nodes, device_type="cpu")
        fn = getattr(ft, driver)
        if driver == "dual_gen_feast":
            res = fn(A, B, X0, Xl0, mesh=mesh, device="cpu", **kw)
            out = {"lam": res.lam.numpy(), "Xr": res.Xr.numpy(), "Xl": res.Xl.numpy(),
                   "res": res.res.numpy(), "inside": res.inside.numpy(),
                   "n_iter": res.n_iter, "converged": res.converged}
        else:
            args = (A, X0) if B is None or driver == "feast_compiled" else (A, B, X0)
            if driver == "feast_compiled" and B is not None:
                kw["B"] = B
            out = _host(fn(*args, mesh=mesh, device="cpu", **kw))
    finally:
        fmod._factor_scan = factor_scan
    out["factor_batches"] = batches
    return out


@case
def compiled_steps(A, X0, **kw):
    """feast_compiled(mesh=) through its sweep program run eagerly (the
    all-reduce a step after each update)."""
    import importlib

    import feast_tpu_torch as ft

    fmod = importlib.import_module("feast_tpu_torch.solvers.feast")
    mesh = ft.parallel.node_mesh(device_type="cpu")
    out = _host(fmod._feast_compiled_steps(A, X0, mesh=mesh, device="cpu", **kw))
    fmod.clear_graph_cache()
    return out


@case
def node_sum_spans(A, X0, device_type="cpu", **kw):
    """feast_compiled(mesh=) through the sweep program run eagerly and, on
    the card, its graphs (twice: capture, then replays), each under
    `tracing.recording()`: the results, and per route the `feast.update`
    and `feast.node_sum` spans (tier and attributes) and the `nodes` of
    `feast.factor`."""
    import importlib

    import feast_tpu_torch as ft
    from feast_tpu_torch.utils import tracing

    fmod = importlib.import_module("feast_tpu_torch.solvers.feast")
    mesh = ft.parallel.node_mesh(device_type=device_type)
    routes = [("steps", fmod._feast_compiled_steps)]
    if device_type == "cuda":
        routes += [("graphs", ft.feast_compiled), ("replays", ft.feast_compiled)]
    out = {}
    for route, fn in routes:
        with tracing.recording():
            res = fn(A, X0, mesh=mesh, device=device_type, **kw)
        recs = tracing.spans()
        res = res._replace(**{k: getattr(res, k).cpu() for k in ("lam", "X", "res", "inside")})
        out[route] = _host(res)
        out[route]["spans"] = [(r["name"], r["attrs"]) for r in recs
                               if r["name"] in ("feast.update", "feast.node_sum",
                                                "feast.factor")]
    prog = next(iter(fmod._PROGRAMS.values()))
    out["replay_count"] = prog.replays if prog.graphs else 0
    fmod.clear_graph_cache()
    return out


@case
def in_place(n=6):
    """`node_sum_` on this rank's own tensor: (the sum, whether it kept its
    storage)."""
    import feast_tpu_torch as ft

    mesh = ft.parallel.node_mesh(device_type="cpu")
    s = (torch.arange(n, dtype=torch.float64) + 1j) * (torch.distributed.get_rank() + 1)
    ptr = s.data_ptr()
    ft.parallel.mesh.node_sum_(s, mesh)
    return s.numpy(), s.data_ptr() == ptr


class _Skewed:
    """Sparse products that round differently on each rank, as products
    that accumulate with atomics do on a card: the rank's result scaled by
    1 + rank 2^-50."""

    def __init__(self, skew: bool):
        from feast_tpu_torch.ops import sparse

        self.classes = (sparse.CSR, sparse.DIA) if skew else ()
        self.saved = [c.matvec for c in self.classes]
        f = 1.0 + torch.distributed.get_rank() * 2.0 ** -50
        for c, mv in zip(self.classes, self.saved):
            c.matvec = lambda self_, X, mv=mv: mv(self_, X) * f

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for c, mv in zip(self.classes, self.saved):
            c.matvec = mv


@case
def iterative(A, B, X0, keep_warm=False, skew=False, **kw):
    import feast_tpu_torch as ft

    mesh = ft.parallel.node_mesh(device_type="cpu")
    with _Skewed(skew):
        res = ft.feast_iterative(A, B, X0, mesh=mesh, device="cpu", keep_warm=keep_warm,
                                 keep_q=True, **kw)
    out = _host(res)
    out.update(Q=res.Q.numpy(), n_sweeps=res.n_sweeps,
               warm=None if res.warm is None else res.warm.numpy())
    return out


@case
def shard_nodes(N):
    import feast_tpu_torch as ft

    mesh = ft.parallel.node_mesh(device_type="cpu")
    x = torch.arange(N, dtype=torch.float64).to(torch.complex128).reshape(N, 1)
    return ft.parallel.shard_nodes(x, mesh).numpy()


@case
def row_qr(a, method="cholqr2"):
    import feast_tpu_torch as ft

    mesh = ft.parallel.node_row_mesh(1, torch.distributed.get_world_size(), device_type="cpu")
    Q, R = ft.parallel.row_sharded_qr(torch.as_tensor(a), mesh, method)
    return Q.numpy(), R.numpy()


@case
def sliced(A, interval, n_slices, B=None, parallel=False, steps=False, **kw):
    """feast_sliced on a node mesh, or feast_sliced_parallel on a slice mesh
    (with steps, its sliced program run eagerly: each rank's slices)."""
    import importlib

    import feast_tpu_torch as ft
    from torch.distributed.device_mesh import init_device_mesh

    sl = importlib.import_module("feast_tpu_torch.parallel.slicing")
    world = torch.distributed.get_world_size()
    if parallel:
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("slice",))
        fn = sl._feast_sliced_parallel_steps if steps else ft.parallel.feast_sliced_parallel
        out = fn(A, interval, n_slices, B, mesh=mesh, device="cpu", **kw)
        if steps:
            ft.solvers.clear_graph_cache()
    else:
        mesh = ft.parallel.node_mesh(device_type="cpu")
        out = ft.parallel.feast_sliced(A, interval, n_slices, B, mesh=mesh, **kw)
    return {"lam": out.lam, "X": out.X, "res": out.res, "counts": np.asarray(out.counts),
            "iters": [r.n_iter for r in out.per_slice],
            "converged": [r.converged for r in out.per_slice]}


@case
def rows(A, B, X0, n_node, n_row, skew=False, **kw):
    """feast_iterative_rows on an (n_node, n_row) mesh, with the element
    count of every all-gather this rank took part in."""
    import feast_tpu_torch as ft
    from feast_tpu_torch.parallel import mesh as pmesh

    sizes = []
    gather = pmesh.all_gather

    def recorded(x, mesh, dim):
        out = gather(x, mesh, dim)
        sizes.append(int(out.numel()))
        return out

    pmesh.all_gather = recorded
    try:
        mesh = ft.parallel.node_row_mesh(n_node, n_row, device_type="cpu")
        with _Skewed(skew):
            out = _host(ft.parallel.feast_iterative_rows(A, B, X0, mesh=mesh, **kw))
    finally:
        pmesh.all_gather = gather
    out["gather_sizes"] = sizes
    return out


@case
def row_reduced(a, fn, n_node=1, **kw):
    """ops.qr's `fn` with psum_axis="row" on this rank's row block of a, on
    an (n_node, world / n_node) mesh bound by bind_mesh; every returned
    tensor through np.asarray (which refuses a conjugate or negative bit)."""
    import feast_tpu_torch as ft
    from feast_tpu_torch.ops import qr
    from feast_tpu_torch.parallel import mesh as pmesh

    world = torch.distributed.get_world_size()
    mesh = ft.parallel.node_row_mesh(n_node, world // n_node, device_type="cpu")
    with pmesh.bind_mesh(mesh):
        out = getattr(qr, fn)(ft.parallel.shard_rows(torch.as_tensor(a), mesh),
                              psum_axis="row", **kw)
    return [np.asarray(t) for t in (out if isinstance(out, tuple) else (out,))]


class Pair(NamedTuple):
    re: object
    im: object


def _tree(rank):
    """A nested pytree of rank-dependent (8, 2) tensors."""
    x = torch.arange(16.0, dtype=torch.float64).reshape(8, 2) + 100 * rank
    return {"a": (x, [x.to(torch.complex128), None]), "b": Pair(x, 2 * x)}


def _host_tree(tree):
    from feast_tpu_torch.parallel import mesh as pmesh

    return pmesh._tree_map(lambda t: np.asarray(t), tree)


@case
def mesh_helpers(devices=None):
    """parallel.mesh's helpers on a node mesh in the order `devices`: this
    rank's position, shard_nodes / shard_rows / replicate of a tensor and
    of a pytree, node_sum, all_reduce, gather_nodes."""
    import feast_tpu_torch as ft
    from feast_tpu_torch.parallel import mesh as pmesh

    rank = torch.distributed.get_rank()
    mesh = ft.parallel.node_mesh(devices=devices, device_type="cpu")
    pos, size = pmesh._dim_rank(mesh, "node")
    x = torch.arange(8.0, dtype=torch.float64).to(torch.complex128).reshape(8, 1)
    mine = torch.full((2, 3), rank + 0.5j, dtype=torch.complex128)
    return {"pos": pos, "size": size,
            "shard_nodes": np.asarray(ft.parallel.shard_nodes(x, mesh)),
            "replicate": np.asarray(ft.parallel.replicate(mine, mesh)),
            "left": np.asarray(mine),
            "node_sum": np.asarray(pmesh.node_sum(mine, mesh)),
            "all_reduce": np.asarray(pmesh.all_reduce(mine, mesh, "node")),
            "gather_nodes": np.asarray(pmesh.gather_nodes(mine[:1], mesh)),
            "tree_nodes": _host_tree(ft.parallel.shard_nodes(_tree(rank), mesh)),
            "tree_replicate": _host_tree(ft.parallel.replicate(_tree(rank), mesh))}


@case
def row_mesh_helpers(devices=None):
    """shard_rows of a pytree and all_gather over "row" on a 2 x 2
    ("node", "row") mesh in the order `devices`."""
    import feast_tpu_torch as ft
    from feast_tpu_torch.parallel import mesh as pmesh

    rank = torch.distributed.get_rank()
    mesh = ft.parallel.node_row_mesh(2, 2, devices=devices, device_type="cpu")
    blocks = ft.parallel.shard_rows(_tree(rank), mesh)
    return {"coord": tuple(mesh.get_coordinate()),
            "tree_rows": _host_tree(blocks),
            "gather_rows": np.asarray(pmesh.all_gather(blocks["b"].re, mesh, "row"))}


@case
def mesh_refusals():
    """The messages of node_mesh / node_row_mesh for rank lists that are not
    the whole group, and of psum_axis with no bound mesh."""
    import feast_tpu_torch as ft
    from feast_tpu_torch.ops import qr

    world = torch.distributed.get_world_size()
    out = []
    for call in (lambda: ft.parallel.node_mesh(devices=[0, 1], device_type="cpu"),
                 lambda: ft.parallel.node_mesh(devices=[0] * world, device_type="cpu"),
                 lambda: ft.parallel.node_mesh(devices=list(range(1, world + 1)),
                                               device_type="cpu"),
                 lambda: ft.parallel.node_row_mesh(2, world // 2, devices=[0] * world,
                                                   device_type="cpu"),
                 lambda: qr.orthonormalize(torch.ones(4, 2, dtype=torch.complex128),
                                           psum_axis="row")):
        try:
            call()
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out


@case
def row_ops(A, B, X, dtype="complex128"):
    """rowsharded.row_operators on a (1, world) mesh: this rank's RowBlocks
    of A and B and their products with X (each the whole product)."""
    import feast_tpu_torch as ft
    from feast_tpu_torch.parallel import rowsharded

    world = torch.distributed.get_world_size()
    mesh = ft.parallel.node_row_mesh(1, world, device_type="cpu")
    Ab, Bb = rowsharded.row_operators(A, B, mesh, getattr(torch, dtype))
    Xt = torch.as_tensor(X)
    return {"r0": Ab.r0, "shape": Ab.shape, "AX": np.asarray(Ab.matvec(Xt)),
            "BX": np.asarray(Bb.matvec(Xt)), "diag": np.asarray(Ab.diag)}


@case
def row_amg_apply(A, B, X, z, **build_opts):
    """ops.amg.shifted_preconditioner on rowsharded.row_amg's hierarchy at
    the shift z, applied to X on every rank (the whole result)."""
    import feast_tpu_torch as ft
    from feast_tpu_torch.ops import amg
    from feast_tpu_torch.parallel import rowsharded

    world = torch.distributed.get_world_size()
    mesh = ft.parallel.node_row_mesh(1, world, device_type="cpu")
    h = rowsharded.row_amg(A, B, mesh, dtype=torch.complex128, **build_opts)
    M = amg.shifted_preconditioner(h, torch.tensor(z, dtype=torch.complex128))
    return np.asarray(M(torch.as_tensor(X)))
