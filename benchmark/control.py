"""Readings that set each cell's limits: the compared numbers of sound runs
of the program over many seeds, of the control, and of planted faults, at
the cell's own sizes, in one process (the benchmark's own runs never run
this).

    python -m benchmark.control --workload yolov8l-detect-b32 \\
        --seeds 1-12 --variants program,int8
    python -m benchmark.control --workload yolov8l-train-b16 \\
        --seeds 1-3 --variants program,fp8,half
    python -m benchmark.control --workload yolov8l-train-ddp4 \\
        --seeds 1-12 --variants program,fp8,half,solo

Each line printed is {"seed", "variant", numbers...}.

Detection (the program's timed path, ``check_batches`` calls a seed, all
of them judged): ``program``; ``int8``, the control: the program's own
int8 post-training quantization (``DetectionAlgorithm.quantize_variables``
on the pool), the precision below the configuration's bfloat16. (The
CPU tests plant the detection faults.)

Training (set-up's first ``check_steps`` steps, the warm-up's and the
window's first ``window_check_steps``): ``program``, the program's step
against the float32 reference; the others put the reference in the
program's place: ``fp8``, the control, every convolution's operands
rounded to float8 e4m3; ``half``, the step on the first half of each
batch; ``solo``, rank 0's rows alone (no exchange between ranks); ``f32``, a
witness: the program's own step without bfloat16 or TF32. A step
that leaves the state unchanged reads a ``change_gap`` of 1 by the
measure's definition and needs no run.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List

import torch

from benchmark import common, judge
from benchmark.drivers import detect, train
from benchmark.reference import train as ref_train
from benchmark.reference.nn import fp32


def parse_seeds(text: str) -> List[int]:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi) + 1) if hi else [int(lo)])
    return out


def emit(seed: int, variant: str, numbers: dict) -> None:
    print(json.dumps({"seed": seed, "variant": variant, **numbers}),
          flush=True)


def detect_readings(cell, cfg, seeds, variants, dev, small) -> None:
    for seed in seeds:
        for v in variants:
            run = detect.Cell(cell, cfg, seed, dev, small,
                              "int8" if v == "int8" else None)
            done = []
            for _ in range(run.sizes["check_batches"]):
                idxs = next(run.order)
                done.append((idxs, run.call(idxs)))
            run.model = None
            emit(seed, v, detect.judge_outputs(
                run, [i for i, _ in done],
                [o for _, outs in done for o in outs]))
            del run
            if dev.type == "cuda":
                torch.cuda.empty_cache()


def train_readings(cell, cfg, seeds, variants, dev, small) -> None:
    world = train.sizes_of(cell, small).get("world", cell["chips"])
    opt = cfg["optimizer"]
    kw = train.loss_kwargs(cfg)
    n_check, _ = train.followed(train.sizes_of(cell, small))
    for seed in seeds:
        if world > 1:
            if "program" in variants:
                from benchmark.drivers import train_ddp
                out = train_ddp.run(cell, cfg, seed, 0.0, False, dev, small,
                                    time.perf_counter())
                emit(seed, "program", out["numbers"])
            if variants == ["program"]:
                continue
            main = _inputs_only(cell, cfg, seed, dev, small, world)
        else:
            main = train.rank_main(cell, cfg, seed, 0.0, False, dev, small,
                                   time.perf_counter())
            if "f32" in variants:   # the program without bfloat16 or TF32
                f32 = dict(cfg, overrides=dict(
                    cfg["overrides"], **{"train.mixed_precision": False}))
                with fp32():
                    wit = train.rank_main(cell, f32, seed, 0.0, False, dev,
                                          small, time.perf_counter())
        start, batches = main["start_state"], main["batches"]
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        with torch.device(dev):
            net = train.reference.build(cfg)

        def ref_run(bs, prec="f32"):
            return ref_train.run(net, start, bs, kw, opt["lr"],
                                 opt["warmup_iters"], prec, keep=(n_check,))

        base = ref_run(batches)
        for v in variants:
            if v in ("program", "f32"):
                if world == 1:
                    got = main if v == "program" else wit
                    emit(seed, v, judge.training_numbers(
                        got["checked"], base, start, n_check, detail=True))
                continue
            if v == "fp8":
                got = ref_run(batches, "fp8")
            else:
                keep = len(batches[0]["images"]) // (2 if v == "half"
                                                     else world)
                got = ref_run([{k: t[:keep] for k, t in b.items()}
                               for b in batches])
            emit(seed, v, judge.training_numbers(got, base, start, n_check,
                                                 detail=True))
        del main, net, base
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def _inputs_only(cell, cfg, seed, dev, small, world) -> dict:
    """The starting weights and the first global batches of a seed, as a
    run makes them, without running the program."""
    from benchmark import reference, traffic, weights

    sz = train.sizes_of(cell, small)
    with torch.device("meta"):
        shapes = weights.shapes_of(reference.build(cfg))
    start = weights.make(shapes, seed, cfg["weights"]["train"], dev)
    B = sz["batch_per_rank"] * world
    amp = dev.type == "cuda"
    ring = traffic.train_ring(cell["traffic"], seed, dev, B,
                              sz["input_size"], cfg["max_num_boxes"],
                              cfg["network"]["nc"],
                              torch.bfloat16 if amp else torch.float32)
    return {"start_state": start,
            "batches": train.followed_batches(ring, train.followed(sz)[1])}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="e.g. 1-12 or 5,9,11")
    p.add_argument("--variants", default="program")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--small", action="store_true")
    args = p.parse_args(argv)
    common.set_cache_dirs()
    cell = common.load_json("workloads", args.workload)
    cell["name"] = args.workload
    cfg = common.load_json("configs", cell["config"])
    variants = args.variants.split(",")
    # only the program's own runs take the cell's cards; the reference in
    # its place runs on one
    common.require_device(args.device,
                          cell["chips"] if "program" in variants else 1)
    dev = torch.device(args.device)
    seeds = [common.seed_of(s) for s in parse_seeds(args.seeds)]
    if cell["driver"] == "detect":
        detect_readings(cell, cfg, seeds, variants, dev, args.small)
    else:
        train_readings(cell, cfg, seeds, variants, dev, args.small)


if __name__ == "__main__":
    main()
