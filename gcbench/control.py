"""Readings that the limits of ``gcbench/limits/<workload>.json`` are set
from, on the chip at the cell's own size, several seeds in one process:

    python3 gcbench/control.py --workload <name> --seeds 1,2,3 \
        --mode program|control [--out FILE]

``program``: each seed runs the cell as the benchmark does, with a window
of one step or the sampled frames, and prints the numbers compared (the
lower readings).  ``fault-<name>``: the same with a fault of
``gcbench/faults.py`` planted in the program (and, through
``faults.ENV``, in each rank's process of a data-parallel cell).
``control``: the reference computed with TF32 on, the
precision below the configurations' float32, stands in the program's
place and is held against the reference in float32 (the upper
readings).  Each seed prints one JSON line, with ``correct`` as the
cell's limits judge its numbers and ``over``, the numbers above their
limit; the benchmark's own runs never run this."""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or ".") != os.path.dirname(
                            os.path.abspath(__file__))]


def control_train(cell, seed: int, device: str) -> dict:
    from gcbench import compare, inputs, precision, weights
    from gcbench.kinds.train import follow_reference, step_rng
    from gcbench.reference.train import ReferenceTrainer

    rcfg = weights.reference_config(cell.config)
    beta1 = float(rcfg.train.betas[0])
    traffic = cell.traffic
    samples = inputs.samples(cell, rcfg, seed, device)
    n = int(traffic["followed_steps"])

    def rngs(i):
        return step_rng(seed, i, device)

    precision.tf32()
    low, _ = follow_reference(
        ReferenceTrainer(rcfg, weights.train_models(rcfg, seed, device)),
        samples, rngs, n, beta1, False)
    precision.float32()
    ref, _ = follow_reference(
        ReferenceTrainer(rcfg, weights.train_models(rcfg, seed, device)),
        samples, rngs, n, beta1, False)
    return compare.train_numbers(low, ref)


def control_train_ddp(cell, seed: int, device: str) -> dict:
    from gcbench import compare, precision
    from gcbench.kinds.train_ddp import reference

    precision.tf32()
    low, _ = reference(cell, seed, device)
    precision.float32()
    numbers = compare.train_numbers(low, reference(cell, seed, device)[0])
    # one replica: the control stands in for every rank alike
    numbers["replicas"] = 0.0
    return numbers


def control_frame(cell, seed: int, device: str) -> dict:
    from gcbench import compare, precision
    from gcbench.kinds.frame import Plan, _reference

    plan = Plan(cell, seed)
    precision.tf32()
    low, _ = _reference(plan, cell.traffic, seed, device, False)
    precision.float32()
    ref, _ = _reference(plan, cell.traffic, seed, device, False)
    return compare.frame_numbers(low, ref)


CONTROLS = {"train": control_train, "frame": control_frame,
            "train_ddp": control_train_ddp}


def main(argv) -> int:
    import argparse
    import json

    from gcbench import compare, faults, harness

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--mode", required=True,
                   choices=["program", "control"]
                   + [f"fault-{f}" for f in faults.ALL])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    harness.set_environment(ROOT)
    cell = harness.find_cell(ROOT, args.workload)
    kind = cell.traffic["kind"]
    out = open(args.out, "a") if args.out else None
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        if args.mode != "control":
            patcher = faults.Patcher()
            if args.mode.startswith("fault-"):
                faults.ALL[args.mode[6:]](patcher.setattr)
                os.environ[faults.ENV] = args.mode[6:]
            result, compared = harness.run_cell(
                cell, seed, 0.0, False, "cuda", time.perf_counter())
            patcher.undo()
            os.environ.pop(faults.ENV, None)
            numbers = {k: v for k, (v, _) in compared.items()}
            extra = {"correct": result["correct"],
                     "metrics": result["metrics"],
                     "failed": result["failed"]}
        else:
            numbers = CONTROLS[kind](cell, seed, "cuda")
            correct, compared = compare.judge(numbers, cell.limits)
            extra = {"correct": correct}
        extra["over"] = sorted(k for k, (v, lim) in compared.items()
                               if not v <= lim)
        line = json.dumps({"workload": args.workload, "mode": args.mode,
                           "seed": seed, "numbers": numbers,
                           "s": time.perf_counter() - t0, **extra})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
