"""Segment-level timing of the SDXL request on one GPU, counterpart of the
JAX package's ``profile_bench.py``.

    python3 -m cfgpp_tpu_torch.tools.profile_bench [--model sdxl]

(``--model tiny_sdxl --device cpu`` runs it on the CPU.)  The settings are
fixed to the JAX script's: random weights from seed 0, bf16,
``dpm++_2m_cfgpp`` at w=5, 25 NFE, the model's default resolution (1024^2
for sdxl), and cuDNN and cuBLAS TF32 off (as ``chip_smoke.py`` runs).
Prints the card's name and power limit first.  With `StepTimer` (each call
synchronized; one warm-up, then ``REPS`` = 3 timed calls) it times the
segments a request is made of: the text encode (both encoders for SDXL),
one batch-2 UNet call as the solver loop makes it
(cond and uncond in one batch, the cross-attention k/v precomputed once per
request, as the engine does), and the VAE decode of one latent in the
engine's decode policy (f32 parameters, bf16 compute) and with bf16
parameters too.  Then the JAX script's "modeled total" lines: text + UNet
calls x one call + decode.

Host time per solver step: one whole request through ``sample(callback_fn=,
unrolled=True)``, the engine's own hook.  The callback runs after each
step's work is enqueued: it reads the clock (the step's enqueue ends), then
synchronizes and reads it again (the step's work ends).  Per step, the
enqueue is the time from the previous step's end to this step's callback
(the host queues the step without waiting for the device, so this is host
time), and the wall time is the time between two ends.  Both are set
beside the one-call UNet time; the first step (text encode and zT before
it) is left out.  A step that launches more kernels than the device's
launch queue holds waits in its enqueue for the device whenever the device
is the slower of the two, so the enqueue time is the host's own only when
the device keeps up: one more request under ``torch.profiler`` (no
callback) gives the device's busy seconds (the sum of its kernels',
copies' and memsets' durations), and their share a UNet call beside it.
The busy share divides them by the wall time of a request timed without
the profiler, whose own host cost would lengthen the wall.  One JSON line
closes the output.
"""

from __future__ import annotations

import argparse
import copy
import json
import statistics
import subprocess
import time

import torch

from cfgpp_tpu_torch.utils.profiling import block_until_ready

PROMPT = "a benchmark prompt"
SOLVER, NFE, GUIDANCE, DTYPE = "dpm++_2m_cfgpp", 25, 5.0, torch.bfloat16
REPS = 3


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "--id=0"],
                          capture_output=True, text=True).stdout.strip()


def timed(timer, name: str, fn):
    """One warm-up call, then ``REPS`` calls timed by ``timer``; returns the
    last output and the mean seconds of a call."""
    fn()
    for _ in range(REPS):
        out = timer.time_fn(name, fn)
    return out, timer.summary()[name]["mean_ms"] / 1000.0


def host_per_step(engine, res: int) -> dict:
    """Enqueue and wall seconds of each solver step of one request
    (`sample(unrolled=True)` with a callback that synchronizes)."""
    marks = []

    def callback(step, t, kw):
        enqueued = time.perf_counter()
        block_until_ready(kw["zt"])
        marks.append((enqueued, time.perf_counter()))
        return kw

    engine.sample(["", PROMPT], cfg_guidance=GUIDANCE, seed=42,
                  resolution=res, callback_fn=callback, unrolled=True)
    enqueue = [e - marks[i - 1][1] for i, (e, _) in enumerate(marks) if i]
    wall = [d - marks[i - 1][1] for i, (_, d) in enumerate(marks) if i]
    return {"steps": len(marks), "enqueue_s": enqueue, "wall_s": wall}


def device_busy(engine, res: int) -> dict:
    """Device seconds of one request (the durations of its device events
    summed, from ``torch.profiler``), the wall seconds of that profiled
    request, and of one request without the profiler: the busy share is the
    device seconds over the unprofiled wall."""
    from torch.profiler import ProfilerActivity, profile

    def request():
        t0 = time.perf_counter()
        block_until_ready(engine.sample(["", PROMPT], cfg_guidance=GUIDANCE,
                                        seed=42, resolution=res))
        return time.perf_counter() - t0

    wall = request()
    activities = [ProfilerActivity.CPU]
    if engine.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        profiled_wall = request()
    # the profiler's raw events: building its Python event list for the
    # half a million events of an sdxl request takes tens of seconds
    cuda = torch.autograd.DeviceType.CUDA
    busy = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == cuda) / 1e9
    return {"request_wall_s": wall, "profiled_request_wall_s": profiled_wall,
            "request_device_s": busy, "busy_share": busy / wall}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", default="sdxl")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("profile_bench: needs a CUDA device (or --device"
                         " cpu)")
    from cfgpp_tpu_torch.engine import DiffusionEngine, ModelBundle
    from cfgpp_tpu_torch.models.unet import precompute_cross_kv
    from cfgpp_tpu_torch.utils.profiling import StepTimer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = card() if device.type == "cuda" else "cpu"
    print(name, flush=True)
    bundle = ModelBundle.random_init(args.model, seed=0, dtype=DTYPE,
                                     device=device)
    engine = DiffusionEngine(bundle, solver=SOLVER, nfe=NFE)
    res = engine.default_resolution()
    timer = StepTimer()
    sdxl = bundle.family == "sdxl"

    with torch.inference_mode():
        (ctx, pooled), t_text = timed(
            timer, "text encode" + (" (dual)" if sdxl else ""),
            lambda: engine.text_embed([PROMPT]))

        lat = engine.latent_shape(1, res)
        z = torch.zeros((2,) + lat[1:], dtype=torch.float32, device=device)
        ctx2 = torch.cat([ctx, ctx], dim=0)
        added = ()
        if pooled is not None:
            ids = engine.make_add_time_ids(2, (res, res), (0, 0), (res, res))
            added = (torch.cat([pooled, pooled], dim=0),
                     torch.as_tensor(ids, device=device))
        ckv = precompute_cross_kv(bundle.unet, ctx2)
        t = torch.tensor(500, device=device)
        _, t_unet = timed(
            timer, f"UNet call (batch 2, {res}^2)",
            lambda: bundle.unet(z, t, ctx2, *added, cross_kv=ckv))

        z0 = torch.zeros(lat, dtype=torch.float32, device=device)
        _, t_vae = timed(timer, "VAE decode (engine: f32 params,"
                         f" {str(bundle.vae.compute_dtype)[6:]} compute)",
                         lambda: engine._decode(z0))
        vae16 = copy.deepcopy(bundle.vae).to(torch.bfloat16)
        vae16.compute_dtype = torch.bfloat16
        scale = bundle.config.vae.scaling_factor
        _, t_vae16 = timed(timer, "VAE decode (bf16 params)",
                           lambda: vae16.decode(z0 / scale))
        del vae16

    print(timer.report(), flush=True)
    n_calls = engine.plan.n_steps
    print(f"\nmodeled total: text {t_text * 1000:.0f}ms + scan {n_calls}x"
          f"{t_unet * 1000:.0f}ms + vae {t_vae * 1000:.0f}ms = "
          f"{(t_text + n_calls * t_unet + t_vae) * 1000:.0f}ms", flush=True)
    print(f"with bf16 vae: {(t_text + n_calls * t_unet + t_vae16) * 1000:.0f}ms",
          flush=True)

    host_per_step(engine, res)                       # warm-up
    steps = host_per_step(engine, res)
    enq = statistics.median(steps["enqueue_s"])
    wall = statistics.median(steps["wall_s"])
    busy = device_busy(engine, res)
    per_call = busy["request_device_s"] / n_calls
    print(f"host per solver step ({steps['steps'] - 1} steps after the"
          f" first): enqueue median {enq * 1000:.2f} ms (min"
          f" {min(steps['enqueue_s']) * 1000:.2f}, max"
          f" {max(steps['enqueue_s']) * 1000:.2f}), wall with a sync median"
          f" {wall * 1000:.2f} ms; one UNet call {t_unet * 1000:.2f} ms:"
          f" enqueue {enq / t_unet:.3f}x, wall {wall / t_unet:.3f}x of it"
          f" [{name}]", flush=True)
    print(f"request: {busy['request_wall_s'] * 1000:.2f} ms wall"
          f" ({busy['profiled_request_wall_s'] * 1000:.2f} ms under the"
          f" profiler), {busy['request_device_s'] * 1000:.2f} ms of device"
          f" events (busy {busy['busy_share']:.3f} of the unprofiled wall),"
          f" {per_call * 1000:.2f} ms a UNet call"
          f" with the text encode and decode spread over the {n_calls}"
          f" [{name}]", flush=True)
    record = {"model": args.model, "solver": SOLVER, "nfe": NFE,
              "guidance": GUIDANCE, "resolution": res,
              "dtype": str(DTYPE)[6:],
              "tf32": False, "card": name, "segments": timer.summary(),
              "unet_calls": n_calls, "modeled_total_s":
              t_text + n_calls * t_unet + t_vae,
              "modeled_total_bf16_vae_s": t_text + n_calls * t_unet + t_vae16,
              "host_enqueue_median_s": enq, "step_wall_median_s": wall,
              "unet_call_s": t_unet, "device_s_per_call": per_call,
              **busy, **steps}
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
