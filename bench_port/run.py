"""Run one cell of the port's benchmark once and print its result.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA cards.  The
cell is an entry of ``BENCHMARK.json``: a configuration
(``bench_port/configs/``) under a traffic mix (``bench_port/mixes/``).  The
run draws the weights and the traffic from ``--seed``, warms up the cell's
shapes, then

* ``--trace 0``: drives the entry point for ``--seconds`` (every unit that
  starts inside it runs to its end) and reports the cell's end-to-end
  metrics;
* ``--trace 1``: drives ``trace_units`` units unprofiled, then as many under
  ``torch.profiler``, and reports the cell's per-layer metrics, the busy
  and window seconds and a breakdown;

then checks images of the run against the plain reference
(``bench_port/check.py``), prints each compared number beside its limit as
the last lines of standard error, and prints one JSON line last on standard
output.  It exits non-zero, printing no result, without enough CUDA cards,
or when ``jax``, ``jaxlib``, ``flax`` or the JAX package is loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "cfgpp_tpu")
NAME_CHARS = 160      # of a device operation's name in the breakdown


def set_environment() -> None:
    """What the run's libraries read: no JAX through transformers, the hash
    tokenizer, and every build or kernel cache at a fixed path inside the
    checkout (the port's nvcc builds go to ``build/cfgpp_tpu_torch/``)."""
    os.environ["USE_FLAX"] = "0"
    os.environ.pop("CFGPP_TOKENIZER_DIR", None)
    cache = ROOT / "build" / "bench_port_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def loaded_forbidden():
    """Top-level names of loaded modules that the run may not load."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def card_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "--id=0"], capture_output=True,
            text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as err:
        return f"nvidia-smi: {err!r}"


def p90(values):
    """Nearest-rank 90th percentile."""
    s = sorted(values)
    return s[max(0, -(-9 * len(s) // 10) - 1)]


def run_cell(cell, seed: int, seconds: float, trace: bool, device):
    """Run one cell on ``device``; returns (result dict, every number the
    check computed).  The caller has checked the cards."""
    import torch

    from bench_port import check, readers
    from bench_port.manifest import reader
    from bench_port.system import Program, sync
    from bench_port.traffic import Traffic

    config, mix = cell["config"], cell["mix"]
    device = torch.device(device)
    torch.backends.cudnn.allow_tf32 = config["tf32"]["cudnn"]
    torch.backends.cuda.matmul.allow_tf32 = config["tf32"]["cuda_matmul"]
    print(f"TF32: cuDNN {torch.backends.cudnn.allow_tf32}, cuBLAS matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}", file=sys.stderr)
    program = Program(config, mix, seed, device)
    batched = mix["entry"] == "sample_batch"
    if batched:
        program.open_writer()
    try:
        if trace:
            program.instrument()
        program.warm_up(seed + 1)
        program.spans.times = {}        # the stretches' spans alone
        setup_s = time.perf_counter() - T0
        traffic = Traffic(mix, seed)
        done, failed, metrics, extra = [], 0, {}, {}

        def stretch(units=None, until=None):
            """``units`` units, or every unit that starts within ``until``
            seconds; then the device idle, then every write on disk.
            Returns the seconds to the device idle, to the last write, and
            the number of failed writes."""
            start, n = time.perf_counter(), 0
            while (n < units if until is None
                   else time.perf_counter() - start < until):
                done.append(program.run_unit(traffic.next()))
                n += 1
            sync(device)
            device_s = time.perf_counter() - start
            bad = program.finish()
            return device_s, time.perf_counter() - start, bad

        if not trace:
            _, window_s, failed = stretch(until=seconds)
            images = sum(len(d.unit.prompts) for d in done)
            values = {"setup_s": setup_s,
                      "img_per_s": (images - failed) / window_s,
                      "s_per_image": window_s / images,
                      "p90_request_s": p90([d.latency_s for d in done])}
            for m in cell["end_to_end"]:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
            print(f"window {window_s:.3f} s, {len(done)} units, {images} "
                  f"images, {failed} failed writes", file=sys.stderr)
        else:
            from torch.profiler import ProfilerActivity, profile
            from bench_port.trace import reduce
            k = mix["trace_units"]
            wall_s, written_s, failed = stretch(units=k)
            host = {name: [b - a for a, b in v]
                    for name, v in program.spans.times.items()}
            program.spans.times = {}
            activities = [ProfilerActivity.CPU]
            if device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            program.spans.profiling = True
            with profile(activities=activities) as prof:
                window_s, _, bad = stretch(units=k)
            program.spans.profiling = False
            failed += bad
            t_read = time.perf_counter()
            tr = reduce(prof)
            del prof
            print(f"trace: {k} units unprofiled {wall_s:.3f} s to the "
                  f"device idle, {written_s:.3f} s to the last write; "
                  f"profiled "
                  f"{window_s:.3f} s, read in {time.perf_counter() - t_read:.1f}"
                  f" s; {tr.unmatched} device events without a launch",
                  file=sys.stderr)
            rec = readers.Record(config, mix, k, wall_s, window_s, host, tr)
            for m in cell["per_layer"]:
                value = reader(m["name"])(rec)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            extra = {"busy_s": tr.busy_s, "window_s": window_s}
            top = sorted(tr.ops.items(), key=lambda o: -o[1])[:10]
            breakdown = {"device_ops": [[n[:NAME_CHARS], s] for n, s in top],
                         "idle_gaps": [[n, s] for n, s in tr.gaps]}
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        program.release()
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        ok, numbers = check.check(config, mix, cell["limits"], seed, done,
                                  device)
        print(f"check: {time.perf_counter() - t_check:.1f} s; all numbers: "
              f"{json.dumps(numbers)}", file=sys.stderr)
    finally:
        program.close()
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    result = {"correct": ok and failed == 0,
              "attempted": sum(len(d.unit.prompts) for d in done),
              "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                         "kind": kind, "count": 1,
                         "memory_peak_bytes": int(peak), **extra}}
    if trace:
        result["breakdown"] = breakdown
    result["checks"] = {name: {"value": numbers.get(name), "limit": limit}
                        for name, limit in cell["limits"].items()}
    return result, numbers


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    set_environment()
    import torch

    from bench_port.manifest import cell as load_cell
    cell = load_cell(args.workload)
    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench_port: {args.workload} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    print(f"card: {card_limit()}", file=sys.stderr)
    result, _ = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda:0")
    found = loaded_forbidden()
    if found:
        print(f"bench_port: loaded {found}; the run may not load "
              f"{list(FORBIDDEN)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
