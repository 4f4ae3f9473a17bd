# -*- coding: utf-8 -*-
"""Kernel E1 (``gaussiancity_tpu_torch/csrc/extrude.cu``) on the card, on
the dataset-view map (the synthetic city's 512-pixel REST maps as PNGs)
and on the 2048-pixel Google Earth map (``chip_smoke.py``'s synthetic
capture through ``process_city --skip-views``):

    python3 e1_variants.py
        times pass A and pass B alone (CUDA events over 100 launches) for
        the source as it is and for copies with one part taken out (the
        neighbour reads, the emission), twice, in turns;
    python3 e1_variants.py --trees OLD . . OLD
        runs ``chip_smoke.e1_measure`` of each checkout in turn, each in
        its own process (the whole call, padded, the plain version).

Prints one JSON line per result beside the card's name and power limit.
Needs a card and ``nvcc``; imports no JAX.
"""

import ctypes
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
EMIT = "  const long long end = min(first + count, cap);\n"
NEIGHBOURS = ("  if (!border)  // off the edge: every neighbour lies inside "
              "the map\n")
VARIANTS = {
    "as built": [],
    "no neighbour reads": [(NEIGHBOURS, "  if (false)\n")],
    "no emission": [(EMIT, "  return;\n" + EMIT)],
    "neither": [(NEIGHBOURS, "  if (false)\n"), (EMIT, "  return;\n" + EMIT)],
}


def maps(work: str):
    """{use: E1's arguments} on the card for the two maps."""
    import chip_smoke as cs
    from gaussiancity_tpu_torch.data import dataset_generator as dg
    from gaussiancity_tpu_torch.data import generate_dataset as gd

    view = os.path.join(work, "view")
    dg.dump_projections(cs.synthetic_city()[0], view)
    _, osm_dir, cap = cs.write_google_earth_capture(os.path.join(work, "ge"))
    gd.process_city("GOOGLE_EARTH", cap, osm_dir, skip_views=True,
                    device="cuda")
    return {"dataset view": cs.device_maps(
                dg.load_projections(view)["REST"], "cuda"),
            "Google Earth 2048": cs.device_maps(dg.load_projections(
                os.path.join(cap, "Projection"))["REST"], "cuda")}


def event_ms(fn, iters: int = 100) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def variants(work: str) -> None:
    import torch

    from gaussiancity_tpu_torch import _kernels
    from gaussiancity_tpu_torch.data import dataset_generator as dg
    from gaussiancity_tpu_torch.ops import extrusion as ext

    source = open(os.path.join(_kernels.CSRC, "extrude.cu")).read()
    builds = {}
    for name, subs in VARIANTS.items():
        text = source
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name!r}: {old!r} not found once")
            text = text.replace(old, new)
        src = os.path.join(work, f"v{len(builds)}.cu")
        with open(src, "w") as f:
            f.write(text)
        lib = src[:-3] + ".so"
        builds[name] = (lib, subprocess.Popen(
            [_kernels.nvcc_path(), *_kernels.NVCC_FLAGS, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in builds.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{out}")
        fn = ctypes.CDLL(lib).extrude
        fn.argtypes = _kernels._ARGTYPES["extrude"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    for use, m in maps(work).items():
        args = (*m, dg.get_seg_ins_relations("GOOGLE_EARTH"),
                dg.class_scale_table("GOOGLE_EARTH"), False)
        want = ext.extrude_points_exact(*args)
        launch_args, _ = ext.e1_launch_args(*args)
        stream = _kernels.stream_handle(m[0].device)
        for turn, order in enumerate((list(fns), list(fns)[::-1])):
            for name in order:
                fn = fns[name]
                out = torch.zeros_like(want)
                a = event_ms(lambda: fn(*launch_args, None, 0, stream))
                b = event_ms(lambda: fn(*launch_args, out.data_ptr(),
                                        len(want), stream))
                torch.cuda.synchronize()
                print(json.dumps({
                    "use": use, "variant": name, "turn": turn,
                    "rows": len(want), "pass_a_ms": a, "pass_b_ms": b,
                    "rows_equal": bool(torch.equal(out, want))}),
                    flush=True)


def measure(tree: str, work: str) -> None:
    """``chip_smoke.e1_measure`` of the checkout at ``tree``."""
    sys.path.insert(0, os.path.abspath(tree))
    os.chdir(tree)
    import chip_smoke as cs

    for use, m in maps(work).items():
        r = cs.e1_measure(use, m, include_btm=False)
        print(json.dumps({"tree": tree, "use": use, **r}), flush=True)


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("e1_variants.py needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as work:
        if argv[:1] == ["--measure"]:
            measure(argv[1], work)
        elif argv[:1] == ["--trees"]:
            for tree in argv[1:]:
                subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--measure", tree], check=True)
        else:
            sys.path.insert(0, HERE)
            variants(work)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
