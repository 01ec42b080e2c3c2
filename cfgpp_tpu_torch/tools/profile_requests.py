"""Where one request's device time goes, per form, on one GPU.

    python3 -m cfgpp_tpu_torch.tools.profile_requests [--model sd21_v]
    python3 -m cfgpp_tpu_torch.tools.profile_requests --model sdxl --batch 1 8

Per form (exact, ``--quant dense``, ``--quant all``): one warm-up request,
three timed ones (host clock around ``DiffusionEngine.sample`` and
a synchronize; median and range of s/image), then one request under
``torch.profiler``: the device time summed over its device events (kernels,
copies, memsets), the busy share (that sum over the median s/image) and the
kernels that took the most of it, by name.  Random weights from seed 0,
batch 1, bf16, the model's default resolution, the family's op-point:
``ddim_cfg++`` at lambda=0.6, 50 NFE for the SD models, ``dpm++_2m_cfgpp``
at w=5, 25 NFE for SDXL (``bench.py:72``), ``ddim_cfg++_lightning`` at
w=1, 4 NFE for ``sdxl_lightning`` (the reference's Lightning command,
README.md:70-74); cuDNN and cuBLAS TF32 off, as
``chip_smoke.py`` runs them.  Prints the card's name and power limit, then
one JSON line per form.

``--batch B [B ...]``: the MS-COCO eval command instead
(``cli/text_to_mscoco.py``; ``ddim_cfg++`` at lambda=0.6, 50 NFE, exact),
each request one ``sample_batch`` of B prompts with per-sample streams and
uint8 images on the device, as that CLI runs it; per batch size one JSON
line, with img/s and device seconds per image beside the busy share.
"""

from __future__ import annotations

import argparse
import collections
import json
import statistics
import subprocess
import time

import torch

PROMPT = "a photograph of an astronaut riding a horse"
FORMS = ("exact", "dense", "all")
REQUESTS = 3
# model or, failing that, family: (solver, NFE, guidance)
OP_POINTS = {"sd": ("ddim_cfg++", 50, 0.6), "sdxl": ("dpm++_2m_cfgpp", 25, 5.0),
             "sdxl_lightning": ("ddim_cfg++_lightning", 4, 1.0)}
MSCOCO_OP_POINT = ("ddim_cfg++", 50, 0.6)      # README's MS-COCO command


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "--id=0"],
                          capture_output=True, text=True).stdout.strip()


def one(engine, res: int, w: float, batch=None) -> float:
    """Seconds of one request: ``sample`` of one prompt, or with ``batch``
    one ``sample_batch`` of that many prompts."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if batch is None:
        engine.sample(["", PROMPT], cfg_guidance=w, seed=42, resolution=res)
    else:
        engine.sample_batch("", [f"{PROMPT}, {i}" for i in range(batch)],
                            cfg_guidance=w, seed=42, resolution=res,
                            as_numpy=False, to_uint8=True)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def device_split(engine, res: int, w: float, batch=None, top: int = 12) -> dict:
    """Device seconds of one profiled request, in all and by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        one(engine, res, w, batch)
    by_name = collections.Counter()
    events = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name[:70]] += e.time_range.elapsed_us() / 1e6
            events += 1
    return {"device_s": sum(by_name.values()), "device_events": events,
            "top": [[name, s] for name, s in by_name.most_common(top)]}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", default="sd21_v")
    p.add_argument("--batch", type=int, nargs="+", default=None,
                   help="sample_batch sizes to time at the MS-COCO command")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_requests: needs a CUDA device")
    from cfgpp_tpu_torch.engine import DiffusionEngine, ModelBundle

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = card()
    print(name, flush=True)
    bundle = ModelBundle.random_init(args.model, seed=0, dtype=torch.bfloat16,
                                     device="cuda")
    res = bundle.config.default_resolution
    if args.batch:
        solver, nfe, w = MSCOCO_OP_POINT
        engine = DiffusionEngine(bundle, solver, nfe=nfe)
        for batch in args.batch:
            one(engine, res, w, batch)
            secs = [one(engine, res, w, batch) for _ in range(REQUESTS)]
            med = statistics.median(secs)
            split = device_split(engine, res, w, batch)
            print(json.dumps({
                "model": args.model, "form": "exact", "resolution": res,
                "solver": solver, "nfe": nfe, "guidance": w, "tf32": False,
                "card": name, "batch": batch, "s_per_batch": secs,
                "median_s": med, "images_per_s": batch / med,
                "device_s_per_image": split["device_s"] / batch,
                "busy_share": split["device_s"] / med, **split}), flush=True)
        return
    solver, nfe, w = OP_POINTS.get(args.model, OP_POINTS[bundle.family])
    for form in FORMS:
        b = bundle if form == "exact" else bundle.quantized(form)
        engine = DiffusionEngine(b, solver, nfe=nfe)
        one(engine, res, w)
        secs = [one(engine, res, w) for _ in range(REQUESTS)]
        med = statistics.median(secs)
        split = device_split(engine, res, w)
        print(json.dumps({
            "model": args.model, "form": form, "resolution": res,
            "solver": solver, "nfe": nfe, "guidance": w, "tf32": False,
            "card": name,
            "s_per_image": secs, "median_s": med,
            "busy_share": split["device_s"] / med, **split}), flush=True)
        del engine, b
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
