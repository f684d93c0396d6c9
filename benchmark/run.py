"""One run of one cell of the benchmark of ``tpucv_torch``:

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It builds the cell's model through the program's registry with weights
made on the device from the seed, makes the cell's inputs from the seed,
warms up the cell's own shapes, measures for ``--seconds`` (``--trace 1``:
a traced window instead), checks the outputs against the plain reference
in ``benchmark/reference``, and prints one JSON line: ``correct``,
``attempted``, ``failed``, ``metrics`` (the end-to-end metrics, or with
``--trace 1`` the per-layer ones), ``device``, ``breakdown`` when traced,
and ``checks`` (each compared number and its limit) last.

A cell is ``benchmark/workloads/<cell>.json``; it names a configuration,
``benchmark/configs/<config>.json``, and a driver,
``benchmark/drivers/<driver>.py``. Each per-layer metric is a reader,
``benchmark/metrics/<metric>.py``. Without CUDA, or with fewer cards than
the cell asks for, it exits with an error and prints no result;
``--device cpu --small`` runs a cell at tiny shapes on the CPU (tests).
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from benchmark import common  # noqa: E402


def process_age_s() -> float:
    """Seconds since this process started, from /proc (0 elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--small", action="store_true",
                   help="the cell's tiny shapes (its file's 'small')")
    return p.parse_args(argv)


def main(argv=None) -> int:
    t0 = T0 - process_age_s()
    args = parse(argv)
    common.set_cache_dirs()
    cell = common.load_json("workloads", args.workload)
    cell["name"] = args.workload
    cfg = common.load_json("configs", cell["config"])
    common.require_device(args.device, cell["chips"])

    import torch

    from benchmark import metrics as readers

    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    driver = importlib.import_module(f"benchmark.drivers.{cell['driver']}")
    out = driver.run(cell, cfg, common.seed_of(args.seed), args.seconds,
                     bool(args.trace), dev, args.small, t0)
    limits = cell["limits"]
    checks = {k: {"value": out["numbers"][k], "limit": v}
              for k, v in limits.items()}
    correct = common.checks_hold(checks) and out["failed"] == 0
    device = common.device_info(dev, out["count"], out["peak"])
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"]}
    for k, v in out["counters"].items():
        print(f"counter {k} {v}", file=sys.stderr)
    if dev.type == "cuda":
        print(f"card {common.card_limit()}", file=sys.stderr)
    if args.trace:
        ctx = out["trace_ctx"]
        ctx.update(cell=cell["name"], config=cfg)
        result["metrics"] = readers.read_all(ctx, cell["name"])
        device.update(busy_s=ctx["busy_s"], window_s=ctx["window_s"])
        result["breakdown"] = ctx["trace"].breakdown()
    else:
        result["metrics"] = {k: common.metric(v, u)
                             for k, (v, u) in out["e2e"].items()}
        result["metrics"]["setup_s"] = common.metric(out["setup_s"], "s")
    result["device"] = device
    common.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
