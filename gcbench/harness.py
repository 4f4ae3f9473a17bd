"""The benchmark's entry: finds a cell and its files by name, checks the
card, runs the cell's kind, decides ``correct`` and prints the result.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file found by its name in ``BENCHMARK.json``:

- ``configs[].file``: the configuration as run (``gcbench/configs``);
- ``gcbench/traffic/<traffic>.json``: the traffic mix; its ``kind``
  names the loop ``gcbench/kinds/<kind>.py`` that drives it, a train
  mix's ``sampler`` the module ``gcbench/samplers/<sampler>.py`` that
  makes its samples, and it holds every number the two use;
- ``gcbench/limits/<workload>.json``: the limit of each number the
  comparison reads for that cell;
- ``gcbench/metrics/<metric name>.py``: the reader of a per-layer metric
  (``read(ctx)``, and ``install(ctx)`` where it needs hooks);
- ``gcbench/cities/<builder>.py``: a city that a traffic file's ``city``
  names by its ``builder`` (``gcbench.inputs.city_from``).

A configuration file may name further configuration files of the same
deployment (``companions``) and carry further generators of its own
(``models``: a list of objects with ``model``, ``config`` and
``precision``, each read like a configuration file); each generator
(``model``) appears once among them.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``compared`` (each number beside its limit); the
numbers compared are also the last lines of standard error.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List

FORBIDDEN = ("jax", "jaxlib", "flax", "gaussiancity_tpu")
CACHE_DIR = ".gcbench_cache"
# host threads of the run's libraries: the program drives the card from
# one Python thread, and a pool as wide as the host's cores contends with
# whatever else the host runs
HOST_THREADS = 2


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files, read."""
    name: str
    root: str
    workload: dict
    config: dict  # the configuration file
    # further generators of the deployment: the configuration files it
    # names, and the entries of its ``models``
    companions: Dict[str, dict]
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    def metric_file(self, name: str) -> str:
        return os.path.join(self.root, "gcbench", "metrics", f"{name}.py")


def find_cell(root: str, name: str) -> Cell:
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    (wl,) = [w for w in bench["workloads"] if w["name"] == name] or [None]
    if wl is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    configs = {c["name"]: c for c in bench["configs"]}

    def config_file(cname: str) -> dict:
        return load_json(os.path.join(root, configs[cname]["file"]))

    conf = config_file(wl["config"])
    companions = {c: config_file(c) for c in conf.get("companions", [])}
    more = conf.get("models", [])
    models = [c["model"] for c in [conf, *companions.values(), *more]
              if "model" in c]
    twice = sorted({m for m in models if models.count(m) > 1})
    if twice:
        raise SystemExit(f"{wl['config']}: generators {twice} given twice")
    companions.update({f"{wl['config']}.{m['model']}": m for m in more})
    gc = os.path.join(root, "gcbench")
    traffic = load_json(os.path.join(gc, "traffic", f"{wl['traffic']}.json"))
    limits = load_json(os.path.join(gc, "limits", f"{name}.json"))

    def in_cell(m: dict) -> bool:
        return "workloads" not in m or name in m["workloads"]

    return Cell(name=name, root=root, workload=wl, config=conf,
                companions=companions, traffic=traffic, limits=limits,
                end_to_end=[m for m in bench["end_to_end"] if in_cell(m)],
                per_layer=[m for m in bench["per_layer"] if in_cell(m)])


def load_module(path: str):
    """A module loaded from its file under the cell's root: a per-layer
    metric's reader, or a city builder."""
    name = (f"gcbench_{os.path.basename(os.path.dirname(path))}_"
            + os.path.basename(path)[:-3].replace(".", "_"))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Context:
    """What a per-layer reader may read, filled by the cell's kind in the
    ``--trace 1`` run.

    - ``modules()``: the program's torch modules (the trainer's generator,
      discriminator and perceptual loss; the pipeline's generators);
    - ``unit_s``: the window's time per step or frame, measured before the
      profiler, the stage timers and the hooks were on;
    - ``profile``: the profiled pass (``gcbench.trace.Profile``) over the
      steps or frames whose work the reference counted;
    - ``ranks``: in a data-parallel cell every rank's profiled pass, by
      rank (``profile`` is rank 0's); empty elsewhere;
    - ``n_traced``: the steps or frames of the instrumented pass (the
      followed steps again; one whole orbit of frames);
    - ``stage_ms``: the program's stage times (the instrumented pass for a
      train cell, the window for a frame cell);
    - ``hooks``: what each reader's ``install`` keeps, by reader;
    - ``work``: the work the benchmark counted on the reference for the
      traced steps or frames (``gcbench.work``).
    """
    kind: str
    modules: Callable[[], list] = list
    unit_s: float = 0.0
    n_traced: int = 0
    profile: object = None
    ranks: List[object] = field(default_factory=list)
    stage_ms: Dict[str, list] = field(default_factory=dict)
    hooks: Dict[str, object] = field(default_factory=dict)
    work: Dict[str, object] = field(default_factory=dict)


def set_environment(root: str) -> None:
    """Caches inside the checkout at fixed paths; no JAX through any
    library the program loads; ``HOST_THREADS`` threads for the libraries
    that read it at import."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(HOST_THREADS)
    cache = os.path.join(root, CACHE_DIR)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(cache, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ.pop("GAUSSIANCITY_VGG19_NPZ", None)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str, t_start: float):
    """Run ``cell`` once on ``device``: (the result object, {number
    compared: (value, limit)})."""
    from gcbench.kinds import kind as load_kind

    kind = load_kind(cell.traffic["kind"])
    readers = {m["name"]: load_module(cell.metric_file(m["name"]))
               for m in cell.per_layer} if trace else {}
    return kind.run(cell, seed=seed, seconds=seconds, readers=readers,
                    device=device, t_start=t_start)


def read_per_layer(cell, ctx: Context, readers: dict, result: dict) -> None:
    """Replace the result's metrics by the cell's per-layer metrics that
    their readers found, and add the profiled pass's device times and
    breakdown."""
    metrics = {}
    for m in cell.per_layer:
        v = readers[m["name"]].read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result["metrics"] = metrics
    prof = ctx.profile
    result["device"]["busy_s"] = prof.busy_s()
    result["device"]["window_s"] = prof.window_s
    result["breakdown"] = {"device_ops": prof.by_name(),
                           "idle_gaps": prof.idle_gaps()}
    log("stage ms (median): " + ", ".join(
        f"{k} {statistics.median(v):.3f}" for k, v in ctx.stage_ms.items()))


def finish(result: dict, compared: Dict[str, tuple]) -> None:
    """Print the compared numbers on standard error and the result line,
    ``compared`` last."""
    result["compared"] = {k: {"value": v, "limit": lim}
                          for k, (v, lim) in compared.items()}
    for k, (v, lim) in compared.items():
        log(f"compared {k} {v!r} limit {lim!r}")
    print(json.dumps(result), flush=True)


def main(argv, root: str, t_start: float) -> int:
    args = parse(argv)
    set_environment(root)
    import torch

    torch.set_num_threads(HOST_THREADS)
    cell = find_cell(root, args.workload)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    log(f"card: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; {power_limit()}")
    t0 = time.perf_counter()
    result, compared = run_cell(cell, args.seed, args.seconds,
                                bool(args.trace), "cuda", t_start)
    log(f"run took {time.perf_counter() - t0:.1f} s after set-up began")
    bad = forbidden_modules()
    if bad:
        log(f"loaded forbidden modules: {bad}")
        return 3
    finish(result, compared)
    return 0
