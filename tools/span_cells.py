#!/usr/bin/env python3
"""The port's own spans and counters in a benchmark cell, on one GPU.

    python3 tools/span_cells.py --workload sdxl_lightning_b1 --seed N \
        [--pairs 10] [--out build/spans/CELL.json]

Run from the repository root.  Builds the cell's program as
``bench_port/run.py`` does (``bench_port.system.Program``: the
configuration, weights drawn from ``--seed``, the mix's engine and PNG
writer), warms it up, then:

1. the recorder's cost: ``--pairs`` units of the cell's traffic, each run
   twice, once with the span recorder (``cfgpp_tpu_torch.utils.profiling``)
   off and once on, in turns (off-on, then on-off): each run's wall time
   to the device's idle and its last PNG on disk, and the main thread's
   CPU time;
2. the traced run of ``bench_port/run.py --trace 1``, with the recorder
   on: the harness's wrappers (``Program.instrument``) and ``trace_units``
   units unprofiled, then as many under ``torch.profiler``.  The
   unprofiled stretch gives the spans' host and CPU times and the PNG
   writer's backlog; the profiled one, through
   ``profiling.attribute``, the device time, launches, host waits and
   device idle of each span.  The harness's own reduction
   (``bench_port/trace.py``) runs on the same events without the
   program's ``cfgpp.*`` ranges, so its per-span device times can be set
   beside the program's;
3. the UNet graph runner's counter (``unet.replay``, ``unet.capture``,
   ``unet.eager``) in the warm-up, the recorder-on runs of 1 and the two
   traced stretches: the replay share of each one's UNet calls.

Prints the card's name and power limit first and one JSON object last
(also written to ``--out``).  ``--device cpu --tiny`` runs the cell's mix
at the port's tiny preset on the CPU (no device events there).
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import statistics
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from bench_port.run import card_limit, set_environment  # noqa: E402


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_unit(program, unit, device):
    """One unit to the device's idle and its last write on disk: (wall s,
    main thread CPU s)."""
    t0, c0 = time.perf_counter(), time.thread_time()
    program.run_unit(unit)
    _sync(device)
    program.finish()
    return time.perf_counter() - t0, time.thread_time() - c0


def cost(program, traffic, pairs: int, device, recs: list) -> dict:
    """Each unit twice, recorder off and on, in turns; the recordings of
    the runs with it on are appended to ``recs``."""
    from cfgpp_tpu_torch.utils import profiling
    runs = {"off": [], "on": []}
    spans = []
    for k in range(pairs):
        unit = traffic.next()
        for state in (("off", "on") if k % 2 == 0 else ("on", "off")):
            if state == "on":
                profiling.start_recording()
            runs[state].append(run_unit(program, unit, device))
            if state == "on":
                recs.append(profiling.stop_recording())
                spans.append(len(recs[-1].spans))
    out = {}
    for i, what in enumerate(("wall_ms", "cpu_ms")):
        off = [1e3 * r[i] for r in runs["off"]]
        on = [1e3 * r[i] for r in runs["on"]]
        out[what] = {"off": off, "on": on,
                     "off_median": statistics.median(off),
                     "on_median": statistics.median(on),
                     "on_less_off_median": statistics.median(
                         b - a for a, b in zip(off, on))}
    out["spans_per_unit"] = statistics.median(spans)
    return out


def per_span_ns(fn_calls: int = 200000) -> dict:
    """Host ns of one span with the recorder off and on (no profiler)."""
    from cfgpp_tpu_torch.utils import profiling
    out = {}
    for state in ("off", "on"):
        if state == "on":
            profiling.start_recording()
        t0 = time.perf_counter_ns()
        for i in range(fn_calls):
            with profiling.span("x", i):
                pass
        out[state] = (time.perf_counter_ns() - t0) / fn_calls
        if state == "on":
            profiling.stop_recording()
    return out


def unet_graph(stretches: dict) -> dict:
    """The UNet graph runner's counter (``unet.replay``, ``unet.capture``,
    ``unet.eager``) in each stretch {name: [recordings]}, and the replay
    share of the stretch's UNet calls (%)."""
    out = {}
    for name, recs in stretches.items():
        n = collections.Counter(r.name for rec in recs for r in rec.readings
                                if r.name.startswith("unet."))
        calls = sum(n.values())
        out[name] = {"calls": calls, "replay": n["unet.replay"],
                     "capture": n["unet.capture"], "eager": n["unet.eager"],
                     "replay_share_pct": 100.0 * n["unet.replay"] / calls
                     if calls else None}
    return out


def as_profiler(events):
    """A stand-in for the profiler that `bench_port.trace.reduce` reads."""
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=results))


def traced(program, traffic, k: int, device) -> dict:
    """The traced run with the recorder on; the program's readings."""
    from torch.profiler import ProfilerActivity, profile

    from bench_port.trace import reduce
    from cfgpp_tpu_torch.utils import profiling

    program.instrument()
    program.spans.times = {}

    def stretch():
        start = time.perf_counter()
        for _ in range(k):
            program.run_unit(traffic.next())
        _sync(device)
        wall = time.perf_counter() - start
        program.finish()
        return wall

    rec_u = profiling.start_recording()
    wall_s = stretch()
    profiling.stop_recording()
    harness_host = {n: [b - a for a, b in v]
                    for n, v in program.spans.times.items()}
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    program.spans.profiling = True
    rec_p = profiling.start_recording()
    with profile(activities=activities) as prof:
        window_s = stretch()
    profiling.stop_recording()
    program.spans.profiling = False
    t_read = time.perf_counter()
    events = list(prof.profiler.kineto_results.events())
    del prof
    att = profiling.attribute(events, rec_p.spans)
    # the harness's reduction as it reads a trace without the program's
    # ranges, and (to show what it would need) with them
    harness = reduce(as_profiler(
        [e for e in events if not e.name().startswith("cfgpp.")]))
    harness_all = reduce(as_profiler(events))
    read_s = time.perf_counter() - t_read
    out = readings(rec_u, rec_p, att, harness, harness_host, events, k,
                   wall_s, window_s, read_s, harness_all)
    out["recordings"] = (rec_u, rec_p)
    return out


def _by_name(rec, att, inclusive: bool) -> dict:
    """{span name: summed `Share`} of the profiled stretch, each span's
    own share, or with its subtree's (``inclusive``)."""
    from cfgpp_tpu_torch.utils import profiling
    out = {}
    for s in rec.spans:
        share = att.total(rec.subtree(s) if inclusive else [s])
        out.setdefault(s.name, profiling.Share()).add(share)
    return out


def readings(rec_u, rec_p, att, harness, harness_host, events, k, wall_s,
             window_s, read_s, harness_all) -> dict:
    own = _by_name(rec_p, att, inclusive=False)
    incl = _by_name(rec_p, att, inclusive=True)
    roots_p = [s for s in rec_p.spans if s.root]
    waits = []
    for r in roots_p:
        mine = [s for s in rec_p.spans
                if s.unit == r.unit and s.thread == r.thread]
        waits.append(att.total(mine).waits)
    unet_u = rec_u.named("unet")
    unet_p = rec_p.named("unet")
    decodes = rec_p.named("decode")
    first_pending = {}
    for r in rec_u.readings:
        if r.name == "png.pending":
            first_pending.setdefault(r.unit, r.value)

    def ms(share_s, n):
        return None if not n else 1e3 * share_s / n

    program_unet = ms(att.total(unet_p).device_s, len(unet_p))
    program_decode = ms(att.total(decodes).device_s, len(decodes))
    harness_unet = ms(sum(harness.spans.get("unet", [])),
                      len(harness.spans.get("unet", [])))
    harness_vae = ms(sum(harness.spans.get("vae", [])),
                     len(harness.spans.get("vae", [])))
    metrics = {
        "text_ms_per_unit": 1e3 * incl["text"].device_s / k,
        "text_ms_per_unit_harness_wrapper":
            1e3 * sum(harness.spans.get("text", [])) / k,
        "host_cpu_ms_per_unet_call": 1e3 * statistics.mean(
            s.cpu_ns for s in unet_u) / 1e9 if unet_u else None,
        "host_wall_ms_per_unet_call": 1e3 * statistics.mean(
            s.end_ns - s.start_ns for s in unet_u) / 1e9 if unet_u else None,
        "launches_per_unet_call": att.total(unet_p).launches / len(unet_p)
        if unet_p else None,
        "host_syncs_per_unit": sum(waits) / k,
        "text_idle_ms": 1e3 * incl["text"].idle_s / k,
        "png_backlog": statistics.mean(first_pending.values())
        if first_pending else None,
        "unet_calls_per_unit": len(unet_p) / k,
        "program_unet_ms_per_call": program_unet,
        "harness_unet_ms_per_call": harness_unet,
        "program_decode_ms_per_image": program_decode,
        "harness_vae_ms_per_image": harness_vae,
    }
    if program_unet and harness_unet:
        metrics["unet_program_over_harness"] = program_unet / harness_unet
    if program_decode and harness_vae:
        metrics["decode_program_over_harness"] = program_decode / harness_vae

    def host_own(rec):
        """{name: host wall less the children's, CPU, count}, a unit."""
        out = {}
        for s in rec.spans:
            kids = sum(c.end_ns - c.start_ns for c in rec.spans
                       if c.parent == s.id)
            h = out.setdefault(s.name, {"wall_ms": 0.0, "cpu_ms": 0.0,
                                        "count": 0})
            h["wall_ms"] += (s.end_ns - s.start_ns - kids) / 1e6 / k
            h["cpu_ms"] += s.cpu_ns / 1e6 / k
            h["count"] += 1
        return out

    import torch
    cuda = torch.autograd.DeviceType.CUDA
    runtime = {}                 # CUDA API calls by name
    for e in events:
        if e.device_type() != cuda and e.name().startswith("cu"):
            runtime[e.name()] = runtime.get(e.name(), 0) + 1
    return {
        "units": k, "wall_s": wall_s, "window_s": window_s,
        "read_s": read_s, "busy_s": att.busy_s,
        "harness_busy_s": harness.busy_s,
        "harness_with_program_ranges": {
            "busy_s": harness_all.busy_s, "unmatched": harness_all.unmatched,
            "unet_ms_per_call": 1e3 * statistics.mean(
                harness_all.spans["unet"]) if harness_all.spans.get("unet")
            else None,
            "cfgpp_ops": sum(1 for n in harness_all.ops
                             if n.startswith("cfgpp."))},
        "idle_share_pct": 100.0 * (1.0 - att.busy_s / wall_s),
        "metrics": metrics,
        "per_unit_by_span": {
            name: {"device_ms": 1e3 * own[name].device_s / k,
                   "launches": own[name].launches / k,
                   "waits": own[name].waits / k,
                   "wait_ms": 1e3 * own[name].wait_s / k,
                   "idle_ms": 1e3 * own[name].idle_s / k,
                   "incl_device_ms": 1e3 * incl[name].device_s / k,
                   "incl_idle_ms": 1e3 * incl[name].idle_s / k}
            for name in own},
        "outside_per_unit": {f: v / k for f, v in dataclasses.asdict(
            att.outside).items()},
        "idle_by_span": {name: own[name].idle_s for name in own},
        "host_per_unit_unprofiled": host_own(rec_u),
        "host_per_unit_profiled": host_own(rec_p),
        "harness_host_ms": {n: 1e3 * statistics.mean(v)
                            for n, v in harness_host.items() if v},
        "harness_idle_gaps": harness.gaps,
        "runtime_calls": dict(sorted(runtime.items(), key=lambda x: -x[1])[
            :25]),
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--pairs", type=int, default=10)
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    set_environment()
    import torch

    from bench_port.manifest import cell as load_cell
    from bench_port.system import Program
    from bench_port.traffic import Traffic

    device = torch.device(args.device)
    if args.tiny:
        from bench_port.tests.tiny import tiny_cell
        cell = tiny_cell(args.workload)
    else:
        cell = load_cell(args.workload)
    config, mix = cell["config"], cell["mix"]
    card = card_limit() if device.type == "cuda" else "cpu"
    print(f"card: {card}", flush=True)
    torch.backends.cudnn.allow_tf32 = config["tf32"]["cudnn"]
    torch.backends.cuda.matmul.allow_tf32 = config["tf32"]["cuda_matmul"]
    program = Program(config, mix, args.seed, device)
    if mix["entry"] == "sample_batch":
        program.open_writer()
    from cfgpp_tpu_torch.utils import profiling
    try:
        with profiling.recording() as warm:
            program.warm_up(args.seed + 1)
        traffic = Traffic(mix, args.seed)
        cost_recs = []
        out = {"workload": args.workload, "seed": args.seed, "card": card,
               "per_span_ns": per_span_ns(),
               "cost": cost(program, traffic, args.pairs, device, cost_recs)}
        print(f"cost: {json.dumps(out['cost'])}", flush=True)
        out.update(traced(program, traffic, mix["trace_units"], device))
        unprofiled, profiled = out.pop("recordings")
        out["unet_graph"] = unet_graph({
            "warm_up": [warm], "cost_on": cost_recs,
            "unprofiled": [unprofiled], "profiled": [profiled]})
        print(f"unet graph: {json.dumps(out['unet_graph'])}", flush=True)
    finally:
        program.close()
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return out


if __name__ == "__main__":
    main()
