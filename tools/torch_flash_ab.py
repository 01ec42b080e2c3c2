#!/usr/bin/env python3
"""A/B of two builds of the port's bf16 flash-attention kernel on one GPU.

    python3 tools/torch_flash_ab.py --baseline OLD/flash_attention.cu \
        [--rounds 2] [--out build/flash_ab.json]

Run from the repository root on a machine with an NVIDIA GPU, nvcc and
PyTorch for CUDA.  ``--baseline`` is another version of
``cfgpp_tpu_torch/csrc/flash_attention.cu`` with the same C entry points
(e.g. the parent commit's, from ``git show``).  Both are built with the
port's nvcc flags and swapped under the same wrappers, so everything else in
the process is the same.  In order:

1. per shape of ``chip_smoke.py``'s ``ATTENTION_CASES`` and
   ``PACKED_CASES``: each build against the plain version (2e-2 x max|ref|,
   chip_smoke's rule; a failure stops the run) and its time per call, taken
   in turns baseline, change, change, baseline (CUDA events, 20 warm calls);
2. the host time of one wrapper call (the enqueue, no synchronise) at the
   UNet mid-block shape, the same turns;
3. SD-1.5 ``ddim_cfg++`` exact requests at chip_smoke's settings (random
   weights from seed 0, 512^2, 50 NFE, batch 1), ``--rounds`` rounds of
   baseline, change, change, baseline: seconds per image; then one
   profiled request each (``torch.profiler``): device time per request,
   the flash kernels' share of it, and the busy share against the
   unprofiled median (``--rounds 0`` skips this phase).

Prints a line per measurement with the card's name and power limit, and
one JSON object as the last line (also written to ``--out``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (the repo root is on the path now)


def build(src: Path, out: Path) -> ctypes.CDLL:
    from cfgpp_tpu_torch.kernels import build as kb

    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [kb._nvcc(), *kb.NVCC_FLAGS, "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        cs.fail(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    usage = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
             if "registers" in ln]
    print(f"  built {src} -> {out.name}: {'; '.join(usage)}", flush=True)
    lib = ctypes.CDLL(str(out))
    lib.cfgpp_flash_attention_hd.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.cfgpp_flash_attention_qkv_packed.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.cfgpp_flash_attention_hd.restype = ctypes.c_int
    lib.cfgpp_flash_attention_qkv_packed.restype = ctypes.c_int
    return lib


def use(fa, lib) -> None:
    """Point the wrappers at ``lib``."""
    fa._lib = lambda: lib


def turns(fa, libs, measure) -> dict:
    """baseline, change, change, baseline; returns {name: [two readings]}."""
    got = {name: [] for name in libs}
    for name in ("baseline", "change", "change", "baseline"):
        use(fa, libs[name])
        got[name].append(measure())
    return got


def host_us(fn, reps: int = 200) -> float:
    """Host time per call: ``reps`` calls enqueued, then one synchronise."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def shapes(fa, libs, card) -> list:
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [(site, (b, n, c), nkv, heads, kv_len, calls, False)
             for site, (b, n, c), nkv, heads, kv_len, calls in cs.ATTENTION_CASES]
    cases += [(site, shape, None, heads, None, calls, True)
              for site, shape, heads, calls in cs.PACKED_CASES]
    rows = []
    for site, shape, nkv, heads, kv_len, calls, packed in cases:
        if packed:
            qkv = torch.randn(shape, generator=gen, device="cuda").bfloat16()
            run = (lambda: fa.flash_attention_qkv_packed(qkv, heads))
            want = fa.flash_attention_qkv_packed_reference(qkv.float(), heads)
        else:
            b, n, c = shape
            q, k, v = (torch.randn(s, generator=gen, device="cuda").bfloat16()
                       for s in ((b, n, c), (b, nkv, c), (b, nkv, c)))
            run = (lambda: fa.flash_attention_hd(q, k, v, heads, kv_len=kv_len))
            want = fa.flash_attention_hd_reference(
                q.float(), k.float(), v.float(), heads, kv_len=kv_len)
        scale = want.abs().max().item()
        errs = {}
        for name, lib in libs.items():
            use(fa, lib)
            out = run()
            torch.cuda.synchronize()
            errs[name] = (out.float() - want).abs().max().item()
            cs.check(bool(torch.isfinite(out).all())
                     and errs[name] <= cs.KERNEL_REL_TOL * scale,
                     f"{name} build disagrees with the plain version at {site}:"
                     f" {errs[name]:.3e} > {cs.KERNEL_REL_TOL} x {scale:.3e}")
        ms = turns(fa, libs, lambda: cs.time_ms(run))
        row = {"site": site, "shape": list(shape), "packed": packed,
               "calls_per_request": calls, "max_abs_err": errs,
               "ms": ms, "ms_mean": {k: statistics.mean(v)
                                     for k, v in ms.items()}}
        rows.append(row)
        print(f"  {'packed ' if packed else ''}{site} {list(shape)}: ms"
              f" baseline {ms['baseline']} change {ms['change']};"
              f" err {errs['baseline']:.3e} / {errs['change']:.3e}"
              f" (tol {cs.KERNEL_REL_TOL} x {scale:.3e}) [{card}]", flush=True)
    return rows


def device_profile(engine, fa) -> dict:
    from torch.profiler import ProfilerActivity, profile

    kw = dict(cfg_guidance=cs.GUIDANCE, seed=cs.SEED,
              resolution=cs.RESOLUTION)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.sample(["", cs.PROMPTS[0]], **kw)
        torch.cuda.synchronize()
    total = flash = 0.0
    for e in prof.events():   # device events: kernels, copies, memsets
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            total += us
            if "flash_fwd" in e.name:
                flash += us
    return {"device_s": total / 1e6, "flash_s": flash / 1e6}


def requests(fa, libs, card, rounds) -> dict:
    from cfgpp_tpu_torch.engine import DiffusionEngine, ModelBundle

    bundle = ModelBundle.random_init("sd15", seed=0, dtype=torch.bfloat16,
                                     device="cuda")
    engine = DiffusionEngine(bundle, "ddim_cfg++", nfe=cs.NFE)
    kw = dict(cfg_guidance=cs.GUIDANCE, seed=cs.SEED,
              resolution=cs.RESOLUTION)

    def one():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.sample(["", cs.PROMPTS[0]], **kw)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    use(fa, libs["change"])
    one()   # warm-up: cuDNN plans, allocator
    seconds = {name: [] for name in libs}
    for _ in range(rounds):
        for name, got in turns(fa, libs, one).items():
            seconds[name] += got
    out = {}
    for name, lib in libs.items():
        use(fa, lib)
        prof = device_profile(engine, fa)
        med = statistics.median(seconds[name])
        out[name] = {"s_per_image": seconds[name], "median_s": med,
                     **prof, "busy_share": prof["device_s"] / med}
        print(f"  exact {name}: s/image {[round(s, 4) for s in seconds[name]]}"
              f" median {med:.4f}; profiled request: device {prof['device_s']:.4f}"
              f" s, flash kernels {prof['flash_s']:.4f} s, busy"
              f" {prof['device_s'] / med:.1%} of the median [{card}]",
              flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path, required=True)
    ap.add_argument("--rounds", type=int, default=2,
                    help="rounds of exact requests; 0: per-shape times only")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_flash_ab: no CUDA device", file=sys.stderr)
        sys.exit(2)
    from cfgpp_tpu_torch.kernels import build as kb
    from cfgpp_tpu_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_name_and_power()
    print(card, flush=True)
    srcs = {"baseline": args.baseline,
            "change": kb.CSRC_DIR / "flash_attention.cu"}
    with ThreadPoolExecutor(2) as pool:
        futs = {name: pool.submit(build, src, kb.BUILD_DIR / f"ab_{name}.so")
                for name, src in srcs.items()}
        libs = {name: f.result() for name, f in futs.items()}

    result = {"card": card, "shapes": shapes(fa, libs, card)}
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((2, 64, 1280), generator=gen, device="cuda").bfloat16()
    kv = torch.randn((2, 77, 1280), generator=gen, device="cuda").bfloat16()
    result["host_us_per_call"] = turns(fa, libs, lambda: host_us(
        lambda: fa.flash_attention_hd(q, kv, kv, 8)))
    print(f"  host time per wrapper call (mid cross, enqueue only):"
          f" {result['host_us_per_call']} us", flush=True)
    if args.rounds:
        result["exact"] = requests(fa, libs, card, args.rounds)
    line = json.dumps(result)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
