"""A/B of builds of the port's f32 flash-attention library on one GPU.

    git show HEAD~1:cfgpp_tpu_torch/csrc/flash_attention_f32.cu > build/old.cu
    python3 -m cfgpp_tpu_torch.tools.f32_attention_ab --baseline build/old.cu \
        [--variant NAME=OTHER.cu ...] [--rounds 3] [--out FILE.json]

Run from the repository root on a machine with an NVIDIA GPU, nvcc and
PyTorch for CUDA.  ``--baseline`` (e.g. the parent commit's source) and each
``--variant`` are other versions of ``cfgpp_tpu_torch/csrc/
flash_attention_f32.cu`` with the same C entry points.  All are built with
the port's nvcc flags and swapped under the same wrappers, so everything
else in the process is the same.  In order:

1. per f32 shape of ``chip_smoke.py``'s ``ATTENTION_CASES`` and
   ``PACKED_CASES``: each build against the plain version (chip_smoke's f32
   rule, 1e-4 x max|ref|; a failure stops the run), its time per call in
   turns (the builds in order, then in reverse; CUDA events, 20 calls
   queued behind a device spin), ``scaled_dot_product_attention`` in f32 on
   the same inputs and the work's bound; the per-request sums at the exact
   path's calls;
2. ``--rounds`` rounds, each build in turns, of an f32 VAE encode of a
   512^2 image and one f32 SD-1.5 UNet call at 512^2 (batch 2B = 2; random
   weights from seed 0), host clock around each call and a synchronize.
   ``--rounds 0`` skips it.

TF32 is off throughout, as in ``chip_smoke.py``.  Prints a line per
measurement with the card's name and power limit, and one JSON object as
the last line (also written to ``--out``).
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
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[2]


def build(cs, src: Path, out: Path) -> ctypes.CDLL:
    from cfgpp_tpu_torch.kernels import build as kb

    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([kb._nvcc(), *kb.NVCC_FLAGS, "-o", str(out),
                           str(src)], capture_output=True, text=True)
    if proc.returncode:
        cs.fail(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    usage = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"  built {src} -> {out.name}: {'; '.join(usage)}", flush=True)
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cfgpp_flash_attention_hd_f32.argtypes = [p] * 4 + [i] * 6 + [p]
    lib.cfgpp_flash_attention_qkv_packed_f32.argtypes = [p] * 2 + [i] * 4 + [p]
    lib.cfgpp_flash_attention_hd_f32.restype = i
    lib.cfgpp_flash_attention_qkv_packed_f32.restype = i
    return lib


def turns(setups: dict, measure) -> dict:
    """Each setup in order, then in reverse; {name: [two readings]}."""
    got = {name: [] for name in setups}
    for name in list(setups) + list(reversed(setups)):
        setups[name]()
        got[name].append(measure())
    return got


def shapes(cs, fa, rl, setups, card) -> list:
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for site, (b, n, c), nkv, heads, kv_len, calls in cs.ATTENTION_CASES:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                   for shape in ((b, n, c), (b, nkv, c), (b, nkv, c)))
        rows = nkv if kv_len is None else kv_len
        qh, kh, vh = (cs.sdpa_heads(x, heads, r)
                      for x, r in ((q, n), (k, rows), (v, rows)))
        cases.append((
            site, calls,
            lambda q=q, k=k, v=v, h=heads, n_=kv_len: fa.flash_attention_hd(
                q, k, v, h, kv_len=n_),
            lambda q=q, k=k, v=v, h=heads, n_=kv_len:
                fa.flash_attention_hd_reference(q, k, v, h, kv_len=n_),
            lambda qh=qh, kh=kh, vh=vh: F.scaled_dot_product_attention(
                qh, kh, vh),
            rl.flash_attention_f32(b, n, rows, heads, c // heads)))
    for site, (b, n, c3), heads, _ in cs.PACKED_CASES:
        qkv = torch.randn((b, n, c3), generator=gen, device="cuda")
        qh, kh, vh = (cs.sdpa_heads(x, heads, n)
                      for x in qkv.split(c3 // 3, dim=2))
        cases.append((
            site, 0,
            lambda qkv=qkv, h=heads: fa.flash_attention_qkv_packed(qkv, h),
            lambda qkv=qkv, h=heads: fa.flash_attention_qkv_packed_reference(
                qkv, h),
            lambda qh=qh, kh=kh, vh=vh: F.scaled_dot_product_attention(
                qh, kh, vh),
            rl.flash_attention_f32(b, n, n, heads, c3 // 3 // heads)))
    rows = []
    for site, calls, run, ref, library, work in cases:
        want = ref()
        scale = want.abs().max().item()
        errs = {}
        for name, go in setups.items():
            go()
            out = run()
            torch.cuda.synchronize()
            err = (out - want).abs().max().item()
            cs.check(err <= cs.F32_REL_TOL * scale
                     and bool(torch.isfinite(out).all()),
                     f"{name} build disagrees with the plain version at "
                     f"{site}: max err {err:.3e} (scale {scale:.3e})")
            errs[name] = err
        ms = turns(setups, lambda: cs.time_ms(run))
        mean = {name: statistics.mean(v) for name, v in ms.items()}
        sdpa_ms, plain_ms = cs.time_ms(library), cs.time_ms(ref)
        rows.append({"site": site, "calls_per_request": calls,
                     "max_abs_err": errs, "ms": ms, "ms_mean": mean,
                     "sdpa_f32_ms": sdpa_ms, "plain_ms": plain_ms,
                     "bound_ms": work.bound_ms()})
        shown = " ".join(f"{name} {v:.4f}" for name, v in mean.items())
        print(f"  {site}: ms {shown}; sdpa f32 {sdpa_ms:.4f}; plain"
              f" {plain_ms:.4f}; bound {work.bound_ms():.4f} [{card}]",
              flush=True)
    for key in list(setups) + ["sdpa_f32", "plain", "bound"]:
        total = sum(r["calls_per_request"] * (r["ms_mean"][key]
                                              if key in setups
                                              else r[f"{key}_ms"])
                    for r in rows)
        print(f"  per f32 request (calls x ms): {key} {total:.3f} [{card}]",
              flush=True)
    return rows


def model_calls(cs, setups, card, rounds) -> dict:
    from cfgpp_tpu_torch.engine import DiffusionEngine, ModelBundle
    from cfgpp_tpu_torch.models.unet import precompute_cross_kv

    bundle = ModelBundle.random_init("sd15", seed=0, dtype=torch.float32,
                                     device="cuda")
    engine = DiffusionEngine(bundle, "ddim_cfg++", nfe=cs.NFE)
    z, ctx, t, _ = cs.unet_inputs(engine)
    gen = torch.Generator(device="cuda").manual_seed(2)
    img = torch.rand((1, cs.RESOLUTION, cs.RESOLUTION, 3), generator=gen,
                     device="cuda") * 2.0 - 1.0
    calls = {"vae encode": lambda: bundle.vae.encode(img),
             "unet eps": lambda: bundle.unet(
                 z, t, ctx, cross_kv=precompute_cross_kv(bundle.unet, ctx))}
    out = {}
    for what, call in calls.items():
        def one():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.inference_mode():
                call()
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        for go in setups.values():   # warm-up
            go()
            one()
        seconds = {name: [] for name in setups}
        for _ in range(rounds):
            for name, got in turns(setups, one).items():
                seconds[name] += got
        out[what] = {name: {"s": s, "median_s": statistics.median(s)}
                     for name, s in seconds.items()}
        shown = "; ".join(f"{name} {[round(x, 4) for x in s]} median"
                          f" {statistics.median(s):.4f}"
                          for name, s in seconds.items())
        print(f"  f32 {what} s: {shown} [{card}]", flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path, required=True)
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=PATH of a further build to time")
    ap.add_argument("--rounds", type=int, default=3,
                    help="rounds of f32 encodes and UNet calls; 0: shapes "
                         "only")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("f32_attention_ab: no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from cfgpp_tpu_torch.kernels import build as kb
    from cfgpp_tpu_torch.kernels import flash_attention as fa
    from cfgpp_tpu_torch.utils import roofline as rl

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_name_and_power()
    print(card, flush=True)
    srcs = {"baseline": args.baseline,
            "change": kb.CSRC_DIR / "flash_attention_f32.cu"}
    for item in args.variant:
        name, _, path = item.partition("=")
        srcs[name] = Path(path)
    cs.build_all(kb)
    with ThreadPoolExecutor(len(srcs)) as pool:
        futs = {name: pool.submit(build, cs, src,
                                  kb.BUILD_DIR / f"f32_ab_{i}.so")
                for i, (name, src) in enumerate(srcs.items())}
        libs = {name: f.result() for name, f in futs.items()}
    setups = {name: (lambda lib=lib: setattr(fa, "_lib_f32", lambda: lib))
              for name, lib in libs.items()}
    result = {"card": card, "shapes": shapes(cs, fa, rl, setups, card)}
    if args.rounds:
        result["model_calls"] = model_calls(cs, setups, card, args.rounds)
    line = json.dumps(result)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
