"""Readings that the limits of ``gcbench/limits/<workload>.json`` are set
from, on the chip at the cell's own size, several seeds in one process:

    python3 gcbench/control.py --workload <name> --seeds 1,2,3 \
        --mode program|control [--out FILE]

``program``: each seed runs the cell as the benchmark does, with a window
of one step or the sampled frames, and prints the numbers compared (the
lower readings).  ``fault-<name>``: the same with a fault of
``gcbench/faults.py`` planted in the program.  ``control``: the reference computed with TF32 on, the
precision below the configurations' float32, stands in the program's
place and is held against the reference in float32 (the upper
readings).  Each seed prints one JSON line; the benchmark's own runs
never run this."""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or ".") != os.path.dirname(
                            os.path.abspath(__file__))]


def control_train(cell, seed: int, device: str) -> dict:
    from gcbench import compare, inputs, precision, weights
    from gcbench.kinds.train import _follow, _reference
    from gcbench.reference.train import ReferenceTrainer

    rcfg = weights.reference_config(cell.config)
    beta1 = float(rcfg.train.betas[0])
    traffic = cell.traffic
    samples = inputs.sampler(traffic["sampler"])(rcfg, traffic, seed,
                                                 device)
    n = int(traffic["followed_steps"])
    precision.tf32()
    made = weights.train_models(rcfg, seed, device)
    rt = ReferenceTrainer(rcfg, made)
    low = _follow(rt, {"G": rt.generator, "D": rt.discriminator},
                  {"G": rt.g_opt, "D": rt.d_opt}, samples, seed, n, device,
                  lambda t: {"attrs": t.last["attrs"],
                             "crop": t.last["fake"]}, beta1)
    del rt, made
    precision.float32()
    ref, _ = _reference(rcfg, samples, seed, n, device, beta1, False)
    return compare.train_numbers(low, ref)


def control_frame(cell, seed: int, device: str) -> dict:
    from gcbench import compare, precision
    from gcbench.kinds.frame import Plan, _reference

    plan = Plan(cell, seed)
    precision.tf32()
    low, _ = _reference(plan, cell.traffic, seed, device, False)
    precision.float32()
    ref, _ = _reference(plan, cell.traffic, seed, device, False)
    return compare.frame_numbers(low, ref)


def main(argv) -> int:
    import argparse
    import json

    from gcbench import faults, harness

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--mode", required=True,
                   choices=["program", "control"]
                   + [f"fault-{f}" for f in {**faults.TRAIN, **faults.FRAME}])
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
                {**faults.TRAIN, **faults.FRAME}[args.mode[6:]](
                    patcher.setattr)
            result, compared = harness.run_cell(
                cell, seed, 0.0, False, "cuda", time.perf_counter())
            patcher.undo()
            numbers = {k: v for k, (v, _) in compared.items()}
            extra = {"correct": result["correct"],
                     "metrics": result["metrics"],
                     "failed": result["failed"]}
        else:
            fn = control_train if kind == "train" else control_frame
            numbers, extra = fn(cell, seed, "cuda"), {}
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
