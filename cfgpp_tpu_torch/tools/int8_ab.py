"""A/B of builds of the port's int8 GEMM library on one GPU.

    python3 -m cfgpp_tpu_torch.tools.int8_ab --baseline OLD/int8_matmul.cu \
        [--variant NAME=OTHER.cu ...] [--rounds 2] [--out FILE.json]

Run from the repository root on a machine with an NVIDIA GPU, nvcc and
PyTorch for CUDA.  ``--baseline`` (e.g. the parent commit's source, from
``git show``) and each ``--variant`` are other versions of
``cfgpp_tpu_torch/csrc/int8_matmul.cu`` with the same C entry points.  All
are built with the port's nvcc flags and swapped under the same wrappers,
so everything else in the process is the same.  In order:

1. per shape of ``chip_smoke.py``'s ``INT8_MATMUL_CASES`` and
   ``INT8_FF_CASES``: each build against the plain version (chip_smoke's
   rule: exact without a LayerNorm, one bf16 ulp with one; a failure stops
   the run), its time per call in turns (the builds in order, then in
   reverse; CUDA events, 20 calls queued behind a device spin), and
   ``torch._int_mm`` on the same int8 operands; per-request sums;
2. SD-1.5 ``ddim_cfg++`` requests at chip_smoke's settings (random weights
   from seed 0, 512^2, 50 NFE, batch 1), ``--rounds`` rounds: ``--quant
   dense`` with the baseline and this build in turns, and ``--quant all``
   in four forms in turns: the parent (baseline GEMM, the dequantized 3x3
   convs in bf16), this GEMM with the bf16 convs, this GEMM with the f32
   convs (cuDNN's TF32 off, as chip_smoke sets it) and the same with
   PyTorch's default TF32 for convs; then one profiled request of each
   (``torch.profiler``): device time, the GEMM and quantize kernels' share,
   the busy share against the unprofiled median.  ``--rounds 0`` skips it.

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
from contextlib import ExitStack
from pathlib import Path
from unittest import mock

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[2]


def parent_dequant_conv(self, x, gn_scale, gn_bias, residual):
    """The parent commit's `QuantConv._dequant_conv`: a bf16 conv, so the
    sum is rounded to bf16 before the f32 bias and residual adds.  Kept
    here only to time the repair against it."""
    dt = x.dtype
    if gn_scale is not None:
        xf = x.float() * gn_scale.float()[:, :, None, None] \
            + gn_bias.float()[:, :, None, None]
        x = (xf * torch.sigmoid(xf)).to(dt)
    wf = (self.weight.float() * self.weight_scale[:, None, None, None]
          ).to(dt).permute(0, 3, 1, 2)
    y = F.conv2d(x, wf, padding=1).float()
    if self.bias is not None:
        y = y + self.bias[:, None, None]
    if residual is not None:
        y = y + residual.float()
    return y.to(dt)


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
    lib.cfgpp_int8_matmul.argtypes = [p] * 10 + [i] * 5 + [ctypes.c_float, p]
    lib.cfgpp_int8_ff_geglu.argtypes = [p] * 16 + [i] * 5 + [ctypes.c_float, p]
    lib.cfgpp_int8_matmul.restype = lib.cfgpp_int8_ff_geglu.restype = i
    return lib


def turns(setups: dict, measure) -> dict:
    """Each setup in order, then in reverse; {name: [two readings]}."""
    got = {name: [] for name in setups}
    for name in list(setups) + list(reversed(setups)):
        setups[name]()
        got[name].append(measure())
    return got


def shapes(cs, tk, libs, card) -> list:
    from cfgpp_tpu_torch.models.quant import quantize_kernel_int8

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    def weights(k, n):
        wq, ws = quantize_kernel_int8(randn(n, k, scale=k ** -0.5))
        return wq, ws, randn(n, scale=0.1)

    setups = {name: (lambda lib=lib: setattr(tk, "_lib", lambda: lib))
              for name, lib in libs.items()}
    cases = []
    for site, (b, t, k), n, mode, calls in cs.INT8_MATMUL_CASES:
        x = randn(b, t, k).bfloat16()
        wq, ws, bias = weights(k, n)
        kw = {}
        if mode == "ln":
            kw = dict(ln_scale=1.0 + randn(k, scale=0.1),
                      ln_bias=randn(k, scale=0.1))
        elif mode in ("bias_res", "bias"):
            kw["bias"] = bias
            if mode == "bias_res":
                kw["residual"] = randn(b, t, n).bfloat16()
        elif mode == "affine":
            kw = dict(affine_scale=randn(b, k), affine_bias=randn(b, k),
                      bias=bias)
        xq = tk.int8_matmul_stages(x, wq, ws, **kw)[1].reshape(-1, k)
        cases.append(("int8_matmul", site, calls, mode == "ln",
                      lambda x=x, wq=wq, ws=ws, kw=kw: tk.int8_matmul(
                          x, wq, ws, **kw),
                      lambda x=x, wq=wq, ws=ws, kw=kw: tk.int8_matmul_reference(
                          x, wq, ws, **kw),
                      lambda xq=xq, wq=wq: torch._int_mm(xq, wq.t())))
    for site, (b, t, c), calls in cs.INT8_FF_CASES:
        x = randn(b, t, c).bfloat16()
        w1q, w1s, b1 = weights(c, 8 * c)
        w2q, w2s, b2 = weights(4 * c, c)
        kw = dict(ln_scale=1.0 + randn(c, scale=0.1),
                  ln_bias=randn(c, scale=0.1),
                  residual=randn(b, t, c).bfloat16())
        args = (x, w1q, w1s, b1, w2q, w2s, b2)
        _, xq, _, _, hq, _ = tk.int8_ff_geglu_stages(*args, **kw)
        xq, hq = xq.reshape(-1, c), hq.reshape(-1, 4 * c)
        cases.append(("int8_ff_geglu", site, calls, True,
                      lambda args=args, kw=kw: tk.int8_ff_geglu(*args, **kw),
                      lambda args=args, kw=kw: tk.int8_ff_geglu_reference(
                          *args, **kw),
                      lambda xq=xq, hq=hq, w1q=w1q, w2q=w2q: (
                          torch._int_mm(xq, w1q.t()),
                          torch._int_mm(hq, w2q.t()))))
    rows = []
    for kernel, site, calls, ln, run, ref, product in cases:
        want = ref()
        errs = {}
        for name in libs:
            setups[name]()
            out = run()
            torch.cuda.synchronize()
            err = (out.float() - want.float()).abs().max().item()
            off = cs.beyond_one_ulp(out, want)
            ok = (err <= cs.KERNEL_REL_TOL * want.float().abs().max().item()
                  and off <= cs.ULP_SHARE) if ln else err == 0.0
            cs.check(ok and bool(torch.isfinite(out).all()),
                     f"{name} build disagrees with the plain version at "
                     f"{kernel} {site}: max err {err:.3e}, {off:.2e} beyond "
                     "one ulp")
            errs[name] = err
        ms = turns(setups, lambda: cs.time_ms(run))
        mean = {name: statistics.mean(v) for name, v in ms.items()}
        product_ms = cs.time_ms(product)
        rows.append({"kernel": kernel, "site": site, "calls_per_request": calls,
                     "max_abs_err": errs, "ms": ms, "ms_mean": mean,
                     "int8_product_cublaslt_ms": product_ms})
        shown = " ".join(f"{name} {v:.4f}" for name, v in mean.items())
        print(f"  {kernel} {site}: ms {shown}; _int_mm {product_ms:.4f}"
              f" [{card}]", flush=True)
    for kernel in ("int8_matmul", "int8_ff_geglu"):
        sums = {name: sum(r["calls_per_request"] * r["ms_mean"][name]
                          for r in rows if r["kernel"] == kernel)
                for name in libs}
        print(f"  {kernel} per request (calls x mean ms): "
              + " ".join(f"{name} {v:.3f}" for name, v in sums.items())
              + f" [{card}]", flush=True)
    return rows


def device_profile(cs, engine) -> dict:
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.sample(["", cs.PROMPTS[0]], cfg_guidance=cs.GUIDANCE,
                      seed=cs.SEED, resolution=cs.RESOLUTION)
        torch.cuda.synchronize()
    got = {"device_s": 0.0, "gemm_s8_s": 0.0, "quantize_rows_s": 0.0,
           "kernels": 0}
    for e in prof.events():   # device events: kernels, copies, memsets
        if e.device_type == torch.autograd.DeviceType.CUDA:
            s = e.time_range.elapsed_us() / 1e6
            got["device_s"] += s
            got["kernels"] += 1
            for key in ("gemm_s8", "quantize_rows"):
                if key in e.name:
                    got[f"{key}_s"] += s
    return got


def requests(cs, tk, libs, card, rounds) -> dict:
    from cfgpp_tpu_torch.engine import DiffusionEngine, ModelBundle
    from cfgpp_tpu_torch.models import quant

    bundle = ModelBundle.random_init("sd15", seed=0, dtype=torch.bfloat16,
                                     device="cuda")
    state = ExitStack()

    def setup(lib, bf16_conv=False, tf32=False):
        def go():
            state.close()
            tk._lib = lambda: lib
            torch.backends.cudnn.allow_tf32 = tf32
            if bf16_conv:
                state.enter_context(mock.patch.object(
                    quant.QuantConv, "_dequant_conv", parent_dequant_conv))
        return go

    base, change = libs["baseline"], libs["change"]
    paths = {
        "dense": ("dense", {"baseline": setup(base), "change": setup(change)}),
        "all": ("all", {
            "parent": setup(base, bf16_conv=True),
            "gemm, bf16 conv": setup(change, bf16_conv=True),
            "gemm, f32 conv, tf32 off": setup(change),
            "gemm, f32 conv, tf32 on": setup(change, tf32=True)}),
    }
    out = {}
    for path, (mode, setups) in paths.items():
        engine = DiffusionEngine(bundle.quantized(mode), "ddim_cfg++",
                                 nfe=cs.NFE)

        def one():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.sample(["", cs.PROMPTS[0]], cfg_guidance=cs.GUIDANCE,
                          seed=cs.SEED, resolution=cs.RESOLUTION)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        for go in setups.values():   # warm-up: cuDNN plans, allocator
            go()
            one()
        seconds = {name: [] for name in setups}
        for _ in range(rounds):
            for name, got in turns(setups, one).items():
                seconds[name] += got
        out[path] = {}
        for name, go in setups.items():
            go()
            prof = device_profile(cs, engine)
            med = statistics.median(seconds[name])
            out[path][name] = {"s_per_image": seconds[name], "median_s": med,
                               **prof, "busy_share": prof["device_s"] / med}
            print(f"  {path} {name}: s/image"
                  f" {[round(s, 4) for s in seconds[name]]} median {med:.4f};"
                  f" profiled request: device {prof['device_s']:.4f} s"
                  f" ({prof['kernels']} kernels), gemm_s8"
                  f" {prof['gemm_s8_s']:.4f} s, quantize_rows"
                  f" {prof['quantize_rows_s']:.4f} s, busy"
                  f" {prof['device_s'] / med:.1%} of the median [{card}]",
                  flush=True)
        state.close()
        del engine
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = False
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path, required=True)
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=PATH of a further build to time per shape")
    ap.add_argument("--rounds", type=int, default=2,
                    help="rounds of requests; 0: per-shape times only")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("int8_ab: no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from cfgpp_tpu_torch.kernels import build as kb
    from cfgpp_tpu_torch.kernels import int8_matmul as tk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_name_and_power()
    print(card, flush=True)
    srcs = {"baseline": args.baseline,
            "change": kb.CSRC_DIR / "int8_matmul.cu"}
    for item in args.variant:
        name, _, path = item.partition("=")
        srcs[name] = Path(path)
    cs.build_all(kb)
    with ThreadPoolExecutor(len(srcs)) as pool:
        futs = {name: pool.submit(build, cs, src,
                                  kb.BUILD_DIR / f"int8_ab_{i}.so")
                for i, (name, src) in enumerate(srcs.items())}
        libs = {name: f.result() for name, f in futs.items()}
    result = {"card": card, "shapes": shapes(cs, tk, libs, card)}
    if args.rounds:
        result["requests"] = requests(cs, tk, libs, card, args.rounds)
    line = json.dumps(result)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
