"""Data-parallel training over ``chips`` ranks, one a card: the process the
benchmark runs is rank 0; it starts ranks 1..W-1 as child processes of
this module (``python -m benchmark.drivers.train_ddp --child ...``). Every
rank joins ``torch.distributed`` through the program's
``parallel.multihost.initialize`` (``tcp://localhost:<free port>``, NCCL
on the cards, gloo on the CPU) and runs ``drivers.train.rank_main`` with
its rows of each global batch; a ``TCPStore`` on a second free port
carries the window's end and each rank's readings to rank 0, which
checks the first steps against the reference and prints the line. All ranks
leave the process group together; rank 0 then waits for every child and
ends any that outlive it.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import socket
import subprocess
import sys
import time

import torch

from benchmark import common
from benchmark.drivers import train

CHILD_TIMEOUT_S = 120


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _join(world: int, rank: int, port: int, store_port: int, cuda: bool):
    import torch.distributed as dist
    from tpucv_torch.parallel import multihost

    if cuda:
        torch.cuda.set_device(rank)
    else:                         # ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    multihost.initialize(f"tcp://localhost:{port}", world, rank,
                         "nccl" if cuda else "gloo")
    return dist.TCPStore("localhost", store_port, world, rank == 0,
                         timeout=datetime.timedelta(seconds=600))


def world_of(cell: dict, small: bool) -> int:
    return train.sizes_of(cell, small).get("world", cell["chips"])


def run(cell: dict, cfg: dict, seed: int, seconds: float, trace: bool,
        dev: torch.device, small: bool, t0: float) -> dict:
    import torch.distributed as dist

    world = world_of(cell, small)
    cuda = dev.type == "cuda"
    port, store_port = free_port(), free_port()
    args = {"workload": cell["name"], "seed": seed, "seconds": seconds,
            "trace": trace, "small": small, "cuda": cuda, "world": world,
            "port": port, "store_port": store_port}
    kids = [subprocess.Popen(
        [sys.executable, "-m", "benchmark.drivers.train_ddp", "--child",
         json.dumps(dict(args, rank=r))],
        stdout=sys.stderr, cwd=str(common.ROOT.parent))
        for r in range(1, world)]
    try:
        store = _join(world, 0, port, store_port, cuda)
        dev0 = torch.device("cuda", 0) if cuda else dev
        main = train.rank_main(cell, cfg, seed, seconds, trace, dev0, small,
                               t0, world, 0, store)
        others = [json.loads(store.get(f"bench/rank{r}"))
                  for r in range(1, world)]
        # every rank leaves the process group at this point: NCCL's
        # teardown may wait for all of them
        dist.destroy_process_group()
        for kid in kids:
            kid.wait(timeout=CHILD_TIMEOUT_S)
        bad = [k.returncode for k in kids if k.returncode != 0]
        if bad:
            raise SystemExit(f"a rank exited with {bad}")
        return train.result(cfg, cell, main, others, dev0, world, small)
    finally:
        for kid in kids:
            if kid.poll() is None:
                kid.kill()
                kid.wait()


def child(spec: dict) -> None:
    import torch.distributed as dist

    common.set_cache_dirs()
    t0 = time.perf_counter()
    cell = common.load_json("workloads", spec["workload"])
    cell["name"] = spec["workload"]
    cfg = common.load_json("configs", cell["config"])
    rank, cuda = spec["rank"], spec["cuda"]
    store = _join(spec["world"], rank, spec["port"], spec["store_port"], cuda)
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    out = train.rank_main(cell, cfg, common.seed_of(spec["seed"]),
                          spec["seconds"], spec["trace"], dev, spec["small"],
                          t0, spec["world"], rank, store)
    store.set(f"bench/rank{rank}", train.summary_for_rank0(out))
    dist.destroy_process_group()


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--child", required=True)
    child(json.loads(p.parse_args().child))
    os._exit(0)
