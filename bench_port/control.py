"""The control of ``correct``: the reference put in the program's place and
computed in the precision below the one the cell states: fp8 (e4m3, one
scale per tensor, float32 sums) below bfloat16 in each module that the
configuration's family computes in bfloat16 (``compute_dtypes``), and
W4A4 at the W8A8 sites of an int8 cell (``quant`` in its mix).  A module
that the configuration states in float32 keeps it.  For each seed it draws
the cell's traffic as a run does, makes the first ``check_images`` images
of it (or ``--images``: fewer images can only read lower) with the float32
reference and with the control, rounds the control's to uint8 as the
program rounds, and prints the numbers a run compares, beside the cell's
limits.  A sound limit fails the control on every seed.

    python3 bench_port/control.py --workload <cell> --seeds 1 2 3 \\
        [--images N]

It needs a CUDA card (the reference runs at the cell's sizes) and runs no
measured window.  ``tests/test_bench_port_card.py`` holds it as a test.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control_numbers(cell, seed: int, device, images: int = None):
    """The numbers of the control against the reference for each of the
    first ``images`` (the mix's ``check_images``) images of the seed's
    traffic, and the worst of each."""
    from bench_port import families
    from bench_port.check import compare, reference, to_uint8
    from bench_port.reference.ops import F32, Ops
    from bench_port.traffic import Traffic

    mix, config = cell["mix"], cell["config"]
    traffic = Traffic(mix, seed)
    count = images or mix["check_images"]
    drawn = []
    while len(drawn) < count:
        unit = traffic.next()
        for j, prompt in enumerate(unit.prompts):
            index = None if unit.indices is None else unit.indices[j]
            drawn.append((prompt, unit.seed, index))
    ref = reference(config, seed, device, quant=mix["quant"])
    lower = Ops(int_bits=4) if mix["quant"] else Ops(fp8=True)
    family = families.load(config)
    compute = family.compute_dtypes(config)

    def image(ops, prompt, s, index):
        for name, m in ref.modules().items():
            family.set_ops(m, F32 if compute[name] == "float32" else ops)
        return ref.image(mix, mix["null_prompt"], prompt, s,
                         index).cpu().numpy()

    worst, each = {}, []
    for prompt, s, index in drawn[:count]:
        r = image(F32, prompt, s, index)
        c = image(lower, prompt, s, index)
        numbers = compare(to_uint8(c), r)
        each.append(numbers)
        for k, v in numbers.items():
            worst[k] = max(worst.get(k, 0.0), v)
    return each, worst


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--images", type=int, default=None)
    args = p.parse_args(argv)
    import torch

    from bench_port.manifest import cell as load_cell
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        each, worst = control_numbers(cell, seed, "cuda:0", args.images)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": worst, "images": each,
                          "limits": cell["limits"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
