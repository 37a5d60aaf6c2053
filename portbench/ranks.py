"""The ranks of a cell that runs on several cards.

`feast_compiled(mesh=)` is one program over `torch.distributed` (SPMD):
every rank calls it in step, with its own card.  Rank 0 is the harness's
own process; `Group` spawns ranks 1 .. world - 1 here (the spawn context,
so each imports torch and the port afresh, and nothing of JAX), and all of
them meet on a `FileStore` in a temporary folder, so no port is opened:
NCCL on the card, one card a rank, or gloo on the CPU.  Every rank then
builds the same "node" mesh (`parallel.node_mesh`).

  place(A)     rank 0's operator broadcast into a buffer of each worker,
               so A is held once a rank (`parallel.replicate` would copy
               it on rank 0 too)
  solve(...)   the workers told to solve operator k, then rank 0 solving it
               (`feast_solve`); each worker passes a placeholder start, as
               the port broadcasts rank 0's
  close()      every rank's cached sweep program dropped, the workers'
               reports read (their peak memory since their warm-up solves,
               the top-level modules they loaded), the workers joined, the
               group destroyed

A worker that dies ends the run.  On the card a watcher thread ends rank
0's process at once: an all-reduce replayed from a CUDA graph would wait
for the dead rank for ever, and no timeout of the process group sees it.
On the CPU, gloo raises in rank 0's next collective within the group's
timeout (`TIMEOUT_S`).

This module is imported by name (`portbench.ranks`), so a spawned worker
finds it; it imports torch and the port only.
"""

from __future__ import annotations

import datetime
import importlib
import multiprocessing
import multiprocessing.connection
import os
import queue
import shutil
import sys
import tempfile
import threading
import traceback

BACKEND = {"cuda": "nccl", "cpu": "gloo"}
TIMEOUT_S = 300.0     # the process group's timeout, and the wait for a report
LOST = 4              # rank 0's exit code where a worker died on the card
# "module:function" each worker calls with its rank once its mesh is built;
# the benchmark's tests plant faults in a worker with it
WORKER_HOOK = None


def feast_solve(config: dict, A, X0, mesh, device):
    """One solve of `config` through `feast_compiled(mesh=)` on this rank."""
    import feast_tpu_torch as ft

    return ft.feast_compiled(A, X0, c=complex(*config["c"]), r=float(config["r"]),
                             nodes=int(config["nodes"]), iters=int(config["iters"]),
                             tol=float(config["tol"]), mixed_prec=bool(config["mixed_prec"]),
                             mesh=mesh, device=device)


def _broadcast(A):
    """A, rank 0's, broadcast in place: every other rank's A receives it."""
    import torch
    import torch.distributed as dist

    dist.broadcast(torch.view_as_real(A), src=0)
    return A


def _join(device_type: str, rank: int, world: int, store: str, timeout_s: float):
    """This rank in the group, and the node mesh over it."""
    import torch
    import torch.distributed as dist

    import feast_tpu_torch as ft

    if device_type == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group(BACKEND[device_type], store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return ft.parallel.node_mesh(world, device_type=device_type)


def _serve(rank, world, store, device_type, timeout_s, config, hook, inbox, outbox):
    """A worker: join, then serve rank 0's messages until None."""
    import torch
    import torch.distributed as dist

    import feast_tpu_torch as ft

    if device_type == "cpu":
        torch.set_num_threads(1)   # the ranks share the host's cores
    try:
        mesh = _join(device_type, rank, world, store, timeout_s)
        dev = ft.parallel.mesh.mesh_device(mesh)
        if hook:
            module, fn = hook.split(":")
            getattr(importlib.import_module(module), fn)(rank)
        cuda = dev.type == "cuda"
        X0 = torch.zeros((int(config["n"]), int(config["m0"])), dtype=torch.complex128,
                         device=dev)
        ops, served = [], 0
        while (msg := inbox.get()) is not None:
            kind, arg = msg
            if kind == "place":
                ops.append(_broadcast(torch.empty(arg, dtype=torch.complex128, device=dev)))
            else:
                feast_solve(config, ops[arg], X0, mesh, device_type)
                served += 1
                if cuda and served == int(config["warmup_solves"]):
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
        ft.solvers.clear_graph_cache()
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        outbox.put((rank, {"peak_bytes": int(peak),
                           "modules": sorted({m.split(".")[0] for m in sys.modules})}))
        dist.destroy_process_group()
    except BaseException:
        # out at once: the group may be waiting on this rank, and tearing
        # it down could wait for ever; the report is flushed first
        outbox.put((rank, {"error": traceback.format_exc()}))
        outbox.close()
        outbox.join_thread()
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


class Group:
    """Rank 0 and `world - 1` spawned workers on `device_type` ("cuda" or
    "cpu"), for the cell's `config`."""

    def __init__(self, world: int, device_type: str, config: dict):
        ctx = multiprocessing.get_context("spawn")
        self.tmp = tempfile.mkdtemp(prefix="portbench_ranks_")
        store = os.path.join(self.tmp, "store")
        self.inboxes = [ctx.Queue() for _ in range(1, world)]
        self.outbox = ctx.Queue()
        self.procs = [ctx.Process(target=_serve, daemon=True,
                                  args=(r, world, store, device_type, TIMEOUT_S, config,
                                        WORKER_HOOK, self.inboxes[r - 1], self.outbox))
                      for r in range(1, world)]
        for p in self.procs:
            p.start()
        self.ops = []
        self.closing = threading.Event()
        if device_type == "cuda":
            threading.Thread(target=self._watch, daemon=True).start()
        self.mesh = _join(device_type, 0, world, store, TIMEOUT_S)

    def _post(self, msg):
        for q in self.inboxes:
            q.put(msg)

    def place(self, A):
        """A (rank 0's, contiguous, on its card) on every rank."""
        self._post(("place", tuple(A.shape)))
        self.ops.append(_broadcast(A))
        return A

    def solve(self, config: dict, A, X0, device):
        k = next(i for i, op in enumerate(self.ops) if op is A)
        self._post(("solve", k))
        return feast_solve(config, A, X0, self.mesh, device)

    def _watch(self):
        """On the card: end rank 0's process once a worker has died."""
        alive = {p.sentinel: p for p in self.procs}
        while not self.closing.is_set():
            for s in multiprocessing.connection.wait(list(alive), timeout=1.0):
                p = alive[s]
                p.join(timeout=1.0)
                if self.closing.is_set():
                    return
                print(f"portbench: worker {p.name} (pid {p.pid}) exited with code "
                      f"{p.exitcode} during the run; {self._errors()}", file=sys.stderr,
                      flush=True)
                os._exit(LOST)

    def _errors(self) -> str:
        out = []
        while True:
            try:
                rank, rep = self.outbox.get_nowait()
            except queue.Empty:
                return "; ".join(out) or "no report from it"
            out.append(f"rank {rank}: {rep.get('error', 'no error')}")

    def close(self) -> list:
        """Stop every rank; returns the workers' reports in rank order.
        Raises where a worker reports an error, does not report within
        `TIMEOUT_S`, or has died."""
        import torch.distributed as dist

        import feast_tpu_torch as ft

        self.closing.set()
        reports, errors = {}, []
        try:
            ft.solvers.clear_graph_cache()
            if all(p.is_alive() for p in self.procs):
                self._post(None)
                for _ in self.procs:
                    rank, rep = self.outbox.get(timeout=TIMEOUT_S)
                    reports[rank] = rep
                    if "error" in rep:
                        errors.append(f"rank {rank}: {rep['error']}")
            else:
                errors.append("a worker died: " + self._errors())
        except queue.Empty:
            errors.append(f"a worker sent no report within {TIMEOUT_S} s")
        finally:
            for p in self.procs:
                p.join(timeout=30 if not errors else 1)
                if p.is_alive():
                    p.kill()
                    p.join()
            if dist.is_initialized():
                dist.destroy_process_group()
            shutil.rmtree(self.tmp, ignore_errors=True)
        if errors:
            raise RuntimeError("portbench: " + "; ".join(errors))
        return [reports[r] for r in sorted(reports)]
