#!/usr/bin/env python3
"""Run chip_smoke.py's `parallel_surface` checks at one rank a card.

    python3 tools/parallel_surface.py

Spawns one NCCL rank per visible CUDA card and runs, twice on each rank,
the row-reduced QR (`psum_axis="row"` on a (1, cards) ("node", "row")
mesh, against the unsharded call), `cmatmul(precision=)` under both GEMM
backends and the pytree sharding; rank 0 prints each run's dict.  The
`parallel` phase of chip_smoke.py runs the same checks once inside its
own ranks; this runs them alone (about 40 s on four cards).
"""
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402


def run(rank, world, store):
    import torch.distributed as dist

    import chip_smoke
    import feast_tpu_torch as ft

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        for _ in range(2):
            out = chip_smoke.parallel_surface(torch, ft, world)
            if rank == 0:
                print(out, flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("parallel_surface: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout, flush=True)
    world = torch.cuda.device_count()
    mp.spawn(run, args=(world, os.path.join(tempfile.mkdtemp(), "store")), nprocs=world)
