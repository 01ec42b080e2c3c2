"""A/B of builds of the port's int8 GEMM, int8 conv or int8-score attention
library on one GPU.

    python3 -m cfgpp_tpu_torch.tools.int8_ab --baseline OLD/int8_matmul.cu \
        [--library int8_conv|flash_attention_int8] [--variant NAME=OTHER.cu \
        ...] [--rounds 2] [--pairs 1] [--out FILE.json]

Run from the repository root on a machine with an NVIDIA GPU, nvcc and
PyTorch for CUDA.  ``--baseline`` (e.g. the parent commit's source, from
``git show``) and each ``--variant`` are other versions of
``cfgpp_tpu_torch/csrc/<library>.cu`` (``int8_matmul``, the default,
``int8_conv`` or ``flash_attention_int8``) with the same C entry points;
``csrc/`` is on their include path, so they may include its headers.  All
are built with the port's nvcc flags and swapped under the same wrappers,
so everything else in the process is the same.  For ``int8_matmul``, in order:

1. per shape of ``chip_smoke.py``'s ``INT8_MATMUL_CASES`` and
   ``INT8_FF_CASES``: each build against the plain version (chip_smoke's
   rule: exact without a LayerNorm, one bf16 ulp with one; a failure stops
   the run), its time per call in turns (the builds in order, then in
   reverse, ``--pairs`` times; CUDA events, 20 calls queued behind a device
   spin), and ``torch._int_mm`` on the same int8 operands; per-request
   sums, and for each build the ratio of its per-request sum to this
   build's, reading by reading, with its median and quartiles;
2. SD-1.5 ``ddim_cfg++`` requests at chip_smoke's settings (random weights
   from seed 0, 512^2, 50 NFE, batch 1), ``--rounds`` rounds: ``--quant
   dense`` with the baseline and this build in turns, and ``--quant all``
   in four forms in turns: the parent (baseline GEMM, the dequantized 3x3
   convs in bf16), this GEMM with the bf16 convs, this GEMM with the f32
   convs (cuDNN's TF32 off, as chip_smoke sets it) and the same with
   PyTorch's default TF32 for convs; then one profiled request of each
   (``torch.profiler``): device time, the GEMM and quantize kernels' share,
   the busy share against the unprofiled median.  ``--rounds 0`` skips it.

For ``int8_conv``:

1. per shape of ``chip_smoke.py``'s ``CONV_CASES``, in bf16 and in f32:
   each build against the plain version (exact without the prologue, one
   bf16 ulp with it; a failure stops the run; a shape a build refuses is
   not timed for it), its time per call in turns,
   one profiled window of calls per build (device time per call by kernel
   name), cuDNN's bf16 conv of the dequantized weights as the yardstick,
   and the bound (``utils/roofline.py``); per-request sums;
2. ``--quant all`` requests as above, the baseline and this build in turns,
   then one profiled request of each (device time, the conv kernels' share,
   busy share).

For ``flash_attention_int8``:

1. per case of ``chip_smoke.py``'s ``INT8_ATTENTION_CASES``, in bf16 and in
   f32: each build against the plain version (every build within
   chip_smoke's floor of ``KERNEL_REL_TOL`` x max; this build also by its
   rule, one bf16 ulp of the plain value; a failure stops the run, and each
   build's share beyond one ulp is printed), its time per call in turns
   (``--pairs`` times), one profiled window of calls per build (device time
   per call, total and by kernel name), and as yardsticks only, on the same
   inputs, the flash-attention kernel of the inputs' dtype (a bf16 or f32
   score: not the same function) and ``scaled_dot_product_attention``, and
   the bound (``utils/roofline.py``); per-request sums;
2. ``--quant all`` requests as for ``int8_conv``.

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


# Kernel names of each library in a profiler trace (device time by name).
PROFILED = {"int8_matmul": ("gemm_s8", "quantize_rows"),
            "int8_conv": ("conv3x3_s8", "conv_s8", "quantize_windows",
                          "window_amax"),
            "flash_attention_int8": ("flash_fwd_s8", "quantize_k",
                                     "k_absmax")}
# The wrapper module's attribute that returns each library.
LIBRARY_ATTR = {"int8_matmul": "_lib", "int8_conv": "_lib",
                "flash_attention_int8": "_lib_int8"}


def build(cs, src: Path, out: Path, library: str) -> ctypes.CDLL:
    from cfgpp_tpu_torch.kernels import build as kb

    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([kb._nvcc(), *kb.NVCC_FLAGS, "-I", str(kb.CSRC_DIR),
                           "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        cs.fail(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    usage = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"  built {src} -> {out.name}: {'; '.join(usage)}", flush=True)
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    if library == "flash_attention_int8":
        for sfx in ("", "_f32"):
            hd = getattr(lib, f"cfgpp_flash_attention_hd_int8{sfx}")
            packed = getattr(lib, f"cfgpp_flash_attention_qkv_packed_int8{sfx}")
            hd.argtypes = [p] * 9 + [i] * 6 + [ctypes.c_float, p]
            packed.argtypes = [p] * 7 + [i] * 4 + [ctypes.c_float, p]
            hd.restype = packed.restype = i
        return lib
    if library == "int8_conv":
        for fn in (lib.cfgpp_int8_conv3x3, lib.cfgpp_int8_conv3x3_f32):
            fn.argtypes = [p] * 11 + [i] * 6 + [p]
            fn.restype = i
        return lib
    lib.cfgpp_int8_matmul.argtypes = [p] * 10 + [i] * 5 + [ctypes.c_float, p]
    lib.cfgpp_int8_ff_geglu.argtypes = [p] * 16 + [i] * 5 + [ctypes.c_float, p]
    lib.cfgpp_int8_matmul.restype = lib.cfgpp_int8_ff_geglu.restype = i
    return lib


def turns(setups: dict, measure, pairs: int = 1) -> dict:
    """Each setup in order, then in reverse, ``pairs`` times; {name: [2 x
    pairs readings]}."""
    got = {name: [] for name in setups}
    for _ in range(pairs):
        for name in list(setups) + list(reversed(setups)):
            setups[name]()
            got[name].append(measure())
    return got


def quartiles(v: list) -> str:
    q1, med, q3 = statistics.quantiles(v, n=4, method="inclusive")
    return f"{med:.4f} [{q1:.4f}, {q3:.4f}]"


def shapes(cs, tk, libs, card, pairs) -> list:
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
        ms = turns(setups, lambda: cs.time_ms(run), pairs)
        mean = {name: statistics.mean(v) for name, v in ms.items()}
        product_ms = cs.time_ms(product)
        rows.append({"kernel": kernel, "site": site, "calls_per_request": calls,
                     "max_abs_err": errs, "ms": ms, "ms_mean": mean,
                     "int8_product_cublaslt_ms": product_ms})
        shown = " ".join(f"{name} {v:.4f}" for name, v in mean.items())
        print(f"  {kernel} {site}: ms {shown}; _int_mm {product_ms:.4f}"
              f" [{card}]", flush=True)
    for kernel in ("int8_matmul", "int8_ff_geglu", None):
        mine = [r for r in rows if kernel in (None, r["kernel"])]
        sums = {name: sum(r["calls_per_request"] * r["ms_mean"][name]
                          for r in mine)
                for name in libs}
        print(f"  {kernel or 'both'} per request (calls x mean ms): "
              + " ".join(f"{name} {v:.3f}" for name, v in sums.items())
              + f" [{card}]", flush=True)
        # reading i of every shape, summed over the request
        readings = {name: [sum(r["calls_per_request"] * r["ms"][name][i]
                               for r in mine) for i in range(2 * pairs)]
                    for name in libs}
        print(f"  {kernel or 'both'} per request, median [quartiles] over"
              f" {2 * pairs} readings: "
              + "; ".join(f"{name} {quartiles(v)} ms, / change "
                          + quartiles([a / b for a, b in zip(
                              v, readings["change"])])
                          for name, v in readings.items())
              + f" [{card}]", flush=True)
    return rows


def device_times(fn, keys) -> dict:
    """Device seconds of one run of ``fn`` under ``torch.profiler``: all
    device events, their count, and the kernels whose names hold each of
    ``keys``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    got = {"device_s": 0.0, "kernels": 0, **{f"{k}_s": 0.0 for k in keys}}
    for e in prof.events():   # device events: kernels, copies, memsets
        if e.device_type == torch.autograd.DeviceType.CUDA:
            s = e.time_range.elapsed_us() / 1e6
            got["device_s"] += s
            got["kernels"] += 1
            for key in keys:
                if key in e.name:
                    got[f"{key}_s"] += s
                    break
    return got


def device_profile(cs, engine, keys) -> dict:
    return device_times(lambda: engine.sample(
        ["", cs.PROMPTS[0]], cfg_guidance=cs.GUIDANCE, seed=cs.SEED,
        resolution=cs.RESOLUTION), keys)


def conv_shapes(cs, tc, rl, libs, card) -> list:
    """Per CONV_CASES shape, bf16 then f32: every build against the plain
    version, times in turns, a profiled window per build, the bf16 conv of
    the dequantized weights and the bound."""
    from cfgpp_tpu_torch.models.quant import quantize_conv_kernel_int8

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    setups = {name: (lambda lib=lib: setattr(tc, "_lib", lambda: lib))
              for name, lib in libs.items()}
    rows = []
    for dt in (torch.bfloat16, torch.float32):
        for site, (b, h, w, c), o, gn, res, br, calls in cs.CONV_CASES:
            x = randn(b, h, w, c).to(dt)
            wq, ws = quantize_conv_kernel_int8(randn(o, c, 3, 3,
                                                     scale=(9 * c) ** -0.5))
            kw = dict(bias=randn(o, scale=0.1), block_rows=br, out_dtype=dt)
            if gn:
                kw.update(gn_scale=1.0 + randn(b, c, scale=0.2),
                          gn_bias=randn(b, c, scale=0.3))
            if res:
                kw["residual"] = randn(b, h, w, o).to(dt)
            want = tc.int8_conv3x3_reference(x, wq, ws, **kw)
            scale = want.float().abs().max().item()

            def run(x=x, wq=wq, ws=ws, kw=kw):
                return tc.int8_conv3x3(x, wq, ws, **kw)

            errs, kernels = {}, {}
            for name in libs:
                setups[name]()
                try:
                    out = run()
                except RuntimeError as e:   # a shape this build does not take
                    errs[name] = f"refused: {e}"
                    continue
                torch.cuda.synchronize()
                err = (out.float() - want.float()).abs().max().item()
                off = cs.beyond_one_ulp(out, want)
                ok = (err <= cs.KERNEL_REL_TOL * scale
                      and off <= cs.ULP_SHARE) if gn else err == 0.0
                cs.check(ok and bool(torch.isfinite(out).all()),
                         f"{name} build disagrees with the plain version at"
                         f" int8_conv3x3 {site} {dt}: max err {err:.3e},"
                         f" {off:.2e} beyond one ulp")
                errs[name] = err
                prof = device_times(lambda: [run() for _ in range(10)],
                                    PROFILED["int8_conv"])
                kernels[name] = {k[:-2]: v * 1e3 / 10 for k, v in prof.items()
                                 if k.endswith("_s") and v}
            ms = turns({n: setups[n] for n in kernels}, lambda: cs.time_ms(run))
            mean = {name: statistics.mean(v) for name, v in ms.items()}
            row = {"kernel": "int8_conv3x3", "site": site, "dtype": str(dt),
                   "calls_per_request": calls, "max_abs_err": errs, "ms": ms,
                   "ms_mean": mean, "device_ms_by_kernel": kernels,
                   "bound_ms": rl.int8_conv3x3(
                       b, h, w, c, o, groupnorm=gn, residual=res,
                       act=rl.BF16 if dt == torch.bfloat16 else rl.F32
                   ).bound_ms()}
            if dt == torch.bfloat16:
                wf = (wq.float() * ws[:, None, None, None]).bfloat16().permute(
                    0, 3, 1, 2)
                xc = x.permute(0, 3, 1, 2)
                row["bf16_dequant_conv_ms"] = cs.time_ms(
                    lambda: F.conv2d(xc, wf, padding=1))
            rows.append(row)
            shown = " ".join(f"{name} {v:.4f}" for name, v in mean.items())
            split = "; ".join(
                f"{name}: " + ", ".join(f"{k} {v:.4f}" for k, v in ks.items())
                for name, ks in kernels.items())
            print(f"  int8_conv3x3 {site} {dt}: ms {shown}; bound"
                  f" {row['bound_ms']:.4f}; bf16 dequant conv"
                  f" {row.get('bf16_dequant_conv_ms', float('nan')):.4f};"
                  f" profiled ms per call by kernel: {split} [{card}]",
                  flush=True)
    for dt in ("torch.bfloat16", "torch.float32"):
        sums = {name: sum(r["calls_per_request"] * r["ms_mean"][name]
                          for r in rows
                          if r["dtype"] == dt and r["calls_per_request"])
                for name in libs}
        print(f"  int8_conv3x3 {dt} per request (calls x mean ms): "
              + " ".join(f"{name} {v:.3f}" for name, v in sums.items())
              + f" [{card}]", flush=True)
    return rows


def attention_shapes(cs, fa, rl, libs, card, pairs) -> list:
    """Per INT8_ATTENTION_CASES case, bf16 then f32: every build against the
    plain version, times in turns, a profiled window per build, the flash
    kernel of the inputs' dtype, SDPA and the bound."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    setups = {name: (lambda lib=lib: setattr(fa, "_lib_int8", lambda: lib))
              for name, lib in libs.items()}
    rows = []
    for dt in (torch.bfloat16, torch.float32):
        for site, shape, heads, packed, calls in cs.INT8_ATTENTION_CASES:
            b, n, c = shape
            if packed:
                qkv = torch.randn(shape, generator=gen, device="cuda").to(dt)
                q, k, v = qkv.split(c // 3, dim=2)
                run = lambda qkv=qkv: fa.flash_attention_qkv_packed_int8(  # noqa: E731
                    qkv, heads)
                flash = lambda qkv=qkv: fa.flash_attention_qkv_packed(  # noqa: E731
                    qkv, heads)
            else:
                q, k, v = (torch.randn(shape, generator=gen,
                                       device="cuda").to(dt) for _ in range(3))
                run = lambda q=q, k=k, v=v: fa.flash_attention_hd_int8(  # noqa: E731
                    q, k, v, heads)
                flash = lambda q=q, k=k, v=v: fa.flash_attention_hd(  # noqa: E731
                    q, k, v, heads)
            d = q.shape[2] // heads
            unrounded = fa.int8_score_attention_f32(q, k, v, heads, n)
            want = unrounded.bfloat16().float()
            scale = want.abs().max().item()
            errs, kernels = {}, {}
            for name in libs:
                setups[name]()
                out = run()
                torch.cuda.synchronize()
                err = (out.float() - want).abs().max().item()
                off = cs.beyond_one_ulp(out, want)
                cs.check(bool(torch.isfinite(out).all())
                         and err <= cs.KERNEL_REL_TOL * scale,
                         f"{name} build disagrees with the plain version at"
                         f" int8-score attention {site} {dt}: max err"
                         f" {err:.3e}")
                if name == "change":
                    cs.check(off <= cs.ULP_SHARE,
                             f"int8-score attention {site} {dt}: {off:.2e} of"
                             " the elements beyond one bf16 ulp")
                    cs.check_bf16_write(site, out, unrounded)
                errs[name] = {"max_abs_err": err, "beyond_one_ulp": off}
                prof = device_times(lambda: [run() for _ in range(10)],
                                    PROFILED["flash_attention_int8"])
                kernels[name] = {k[:-2]: v * 1e3 / 10 for k, v in prof.items()
                                 if k.endswith("_s") and v}
            ms = turns(setups, lambda: cs.time_ms(run), pairs)
            mean = {name: statistics.mean(v) for name, v in ms.items()}
            qh, kh, vh = (cs.sdpa_heads(x, heads, n) for x in (q, k, v))
            row = {"kernel": "flash_attention_" + (
                       "qkv_packed_int8" if packed else "hd_int8"),
                   "site": site, "dtype": str(dt), "calls_per_request": calls,
                   "max_abs_err": errs, "ms": ms, "ms_mean": mean,
                   "device_ms_by_kernel": kernels,
                   "flash_kernel_ms": cs.time_ms(flash),
                   "sdpa_ms": cs.time_ms(
                       lambda: F.scaled_dot_product_attention(qh, kh, vh)),
                   "bound_ms": rl.flash_attention_int8(
                       b, n, n, heads, d,
                       act=rl.BF16 if dt == torch.bfloat16 else rl.F32
                   ).bound_ms()}
            rows.append(row)
            shown = " ".join(f"{name} {v:.4f}" for name, v in mean.items())
            split = "; ".join(
                f"{name}: " + ", ".join(f"{k} {v:.4f}" for k, v in ks.items())
                for name, ks in kernels.items())
            print(f"  {row['kernel']} {site} {dt}: ms {shown}; errors {errs};"
                  f" {'bf16' if dt == torch.bfloat16 else 'f32'} flash kernel"
                  f" {row['flash_kernel_ms']:.4f}; sdpa {row['sdpa_ms']:.4f};"
                  f" bound {row['bound_ms']:.4f}; profiled ms per call by"
                  f" kernel: {split} [{card}]", flush=True)
    for dt in ("torch.bfloat16", "torch.float32"):
        sums = {name: sum(r["calls_per_request"] * r["ms_mean"][name]
                          for r in rows if r["dtype"] == dt)
                for name in libs}
        print(f"  int8-score attention {dt} per request (calls x mean ms): "
              + " ".join(f"{name} {v:.3f}" for name, v in sums.items())
              + f" [{card}]", flush=True)
    return rows


def requests(cs, tk, tc, libs, card, rounds, library, fa=None) -> dict:
    from cfgpp_tpu_torch.engine import DiffusionEngine, ModelBundle
    from cfgpp_tpu_torch.models import quant

    bundle = ModelBundle.random_init("sd15", seed=0, dtype=torch.bfloat16,
                                     device="cuda")
    state = ExitStack()
    mod = {"int8_conv": tc, "flash_attention_int8": fa}.get(library, tk)

    def setup(lib, bf16_conv=False, tf32=False):
        def go():
            state.close()
            setattr(mod, LIBRARY_ATTR[library], lambda: lib)
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
    if library != "int8_matmul":
        paths = {"all": ("all", {"baseline": setup(base),
                                 "change": setup(change)})}
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
            prof = device_profile(cs, engine, PROFILED[library])
            med = statistics.median(seconds[name])
            out[path][name] = {"s_per_image": seconds[name], "median_s": med,
                               **prof, "busy_share": prof["device_s"] / med}
            split = ", ".join(f"{k[:-2]} {prof[k]:.4f} s"
                              for k in (f"{n}_s" for n in PROFILED[library]))
            print(f"  {path} {name}: s/image"
                  f" {[round(s, 4) for s in seconds[name]]} median {med:.4f};"
                  f" profiled request: device {prof['device_s']:.4f} s"
                  f" ({prof['kernels']} kernels), {split}, busy"
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
    ap.add_argument("--library", choices=sorted(PROFILED),
                    default="int8_matmul")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=PATH of a further build to time per shape")
    ap.add_argument("--rounds", type=int, default=2,
                    help="rounds of requests; 0: per-shape times only")
    ap.add_argument("--pairs", type=int, default=1,
                    help="int8_matmul, flash_attention_int8: rounds of"
                         " per-shape turns")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("int8_ab: no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from cfgpp_tpu_torch.kernels import build as kb
    from cfgpp_tpu_torch.kernels import flash_attention as fa
    from cfgpp_tpu_torch.kernels import int8_conv as tc
    from cfgpp_tpu_torch.kernels import int8_matmul as tk
    from cfgpp_tpu_torch.utils import roofline as rl

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_name_and_power()
    print(card, flush=True)
    srcs = {"baseline": args.baseline,
            "change": kb.CSRC_DIR / f"{args.library}.cu"}
    for item in args.variant:
        name, _, path = item.partition("=")
        srcs[name] = Path(path)
    cs.build_all(kb)
    with ThreadPoolExecutor(len(srcs)) as pool:
        futs = {name: pool.submit(build, cs, src,
                                  kb.BUILD_DIR / f"{args.library}_ab_{i}.so",
                                  args.library)
                for i, (name, src) in enumerate(srcs.items())}
        libs = {name: f.result() for name, f in futs.items()}
    if args.library == "int8_conv":
        rows = conv_shapes(cs, tc, rl, libs, card)
    elif args.library == "flash_attention_int8":
        rows = attention_shapes(cs, fa, rl, libs, card, args.pairs)
    else:
        rows = shapes(cs, tk, libs, card, args.pairs)
    result = {"card": card, "library": args.library, "shapes": rows}
    if args.rounds:
        result["requests"] = requests(cs, tk, tc, libs, card, args.rounds,
                                      args.library, fa)
    line = json.dumps(result)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
