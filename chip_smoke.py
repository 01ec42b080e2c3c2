#!/usr/bin/env python3
"""Smoke run of the PyTorch port (cfgpp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, on a machine
                                 # with an H100, nvcc and PyTorch for CUDA

Phases, one status line each; any failure exits non-zero:

1. card: the card's name and power limit (nvidia-smi), then the build of
   every CUDA kernel of the slice from the sources in this checkout.
2. kernels: each kernel against its plain PyTorch version at the shapes the
   slice gives it (bf16 inputs from a seed; the plain version computes in
   f32), with the tolerance stated, and both times per call.
3. slice: SD-1.5 ``ddim_cfg++``, lambda=0.6, 50 NFE, 512^2, random weights
   from seed 0, bf16, three requests of batch 1 through
   ``DiffusionEngine.sample``.  Checks the images, the kernel launch count
   per request, and one UNet call and one VAE decode against the same
   modules with the plain attention in place of the kernel.
4. summary: a JSON line of the kernels, then the result line
   ``{"ok": true, "device": {...}}``.

Without a CUDA device, or outside the repository, it prints no result and
exits non-zero.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parent

# Tolerances.  Kernel vs plain: the kernel rounds p to bf16 before p@v (as
# the TPU kernel does) and writes bf16, so its error is a few bf16 ulps of
# the output scale.  Model vs model: the same bf16 network with the kernel
# or the plain f32 attention at its 32 (UNet) or 1 (VAE) attention sites.
KERNEL_REL_TOL = 2e-2     # max |kernel - plain| <= tol * max |plain|
MODEL_REL_L2_TOL = 3e-2   # ||kernel path - plain path|| <= tol * ||plain path||

NFE = 50
GUIDANCE = 0.6
RESOLUTION = 512
SEED = 42
PROMPTS = ("a photograph of an astronaut riding a horse",
           "a watercolor painting of a lighthouse at dusk")
UNET_SITES_PER_CALL = 32      # 16 transformer blocks x (self + cross)
LAUNCHES_PER_REQUEST = UNET_SITES_PER_CALL * NFE + 1   # + the VAE mid-block

# (site, q shape, kv rows, heads, kv_len, calls per request).  Heads are 8
# in every SD-1.5 UNet block; 5 transformer blocks per level (2 down, 3 up),
# 1 in the mid block; one VAE mid-block attention per image.
ATTENTION_CASES = [
    ("unet L0 self", (2, 4096, 320), 4096, 8, None, 5 * NFE),
    ("unet L0 cross", (2, 4096, 320), 77, 8, None, 5 * NFE),
    ("unet L1 self", (2, 1024, 640), 1024, 8, None, 5 * NFE),
    ("unet L1 cross", (2, 1024, 640), 77, 8, None, 5 * NFE),
    ("unet L2 self", (2, 256, 1280), 256, 8, None, 5 * NFE),
    ("unet L2 cross", (2, 256, 1280), 77, 8, None, 5 * NFE),
    ("unet mid self", (2, 64, 1280), 64, 8, None, NFE),
    ("unet mid cross", (2, 64, 1280), 77, 8, None, NFE),
    ("vae mid self", (1, 4096, 512), 4096, 1, None, 1),
    ("cross kv padded to 128", (2, 4096, 320), 128, 8, 77, 0),
]


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_name_and_power() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip()


def time_ms(fn, reps: int = 20) -> float:
    """Mean device time per call over ``reps`` calls, after one warm-up."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm()).item()


def phase_kernels(fa, card: str) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, max_err, ms_req, plain_ms_req = [], 0.0, 0.0, 0.0
    for site, (b, n, c), nkv, heads, kv_len, calls in ATTENTION_CASES:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").bfloat16()
                   for shape in ((b, n, c), (b, nkv, c), (b, nkv, c)))
        out = fa.flash_attention_hd(q, k, v, heads, kv_len=kv_len)
        torch.cuda.synchronize()
        ref = fa.flash_attention_hd_reference(q.float(), k.float(), v.float(),
                                              heads, kv_len=kv_len)
        err = (out.float() - ref).abs().max().item()
        scale = ref.abs().max().item()
        ok = bool(torch.isfinite(out).all()) and err <= KERNEL_REL_TOL * scale
        ms = time_ms(lambda: fa.flash_attention_hd(q, k, v, heads, kv_len=kv_len))
        plain_ms = time_ms(lambda: fa.flash_attention_hd_reference(
            q, k, v, heads, kv_len=kv_len))
        print(f"  {site}: q {list(q.shape)} kv {nkv} heads {heads} d {c // heads}"
              f" kv_len {kv_len}: max_abs_err {err:.3e} (tol {KERNEL_REL_TOL}"
              f" x {scale:.3e}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms"
              f" [{card}]", flush=True)
        check(ok, f"flash_attention_hd disagrees with its plain version at {site}")
        max_err = max(max_err, err)
        ms_req += calls * ms
        plain_ms_req += calls * plain_ms
        rows.append({"site": site, "q": [b, n, c], "kv": nkv, "heads": heads,
                     "kv_len": kv_len, "calls_per_request": calls,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    return {"max_abs_err": max_err, "ms": ms_req, "plain_ms": plain_ms_req,
            "shapes": rows}


def phase_models_vs_plain_attention(engine, fa) -> None:
    """One UNet call (batch 2B = 2 at the slice's latent) and one VAE decode,
    each with the kernel and with the plain attention in its place."""
    from cfgpp_tpu_torch.models import attention
    from cfgpp_tpu_torch.models.unet import precompute_cross_kv

    gen = torch.Generator(device="cuda").manual_seed(1)
    unet, vae = engine.bundle.unet, engine.bundle.vae
    s = RESOLUTION // engine.bundle.vae_scale_factor
    z = torch.randn((2, s, s, 4), generator=gen, device="cuda")
    ctx = engine._text_embed_sd(engine.tokenize(["", PROMPTS[0]]))
    t = torch.tensor(501, device="cuda")

    def run():
        with torch.inference_mode():
            eps = unet(z, t, ctx, cross_kv=precompute_cross_kv(unet, ctx))
            img = vae.decode(z[:1] * 3.0)
        return eps, img

    eps_k, img_k = run()
    with mock.patch.object(attention, "flash_attention_hd",
                           fa.flash_attention_hd_reference):
        eps_p, img_p = run()
    for what, got, want in (("unet eps", eps_k, eps_p), ("vae decode", img_k, img_p)):
        err = rel_l2(got, want)
        print(f"  {what}: kernel vs plain attention rel_l2 {err:.3e}"
              f" (tol {MODEL_REL_L2_TOL})", flush=True)
        check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
        check(err <= MODEL_REL_L2_TOL, f"{what}: kernel path disagrees")


def phase_slice(engine, fa, card: str) -> int:
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    images, seconds, counts = [], [], []
    for prompt in (PROMPTS[0], PROMPTS[1], PROMPTS[0]):
        before = fa.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = engine.sample(["", prompt], cfg_guidance=GUIDANCE, seed=SEED,
                            resolution=RESOLUTION)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        counts.append(fa.launches - before)
        check(img.dtype == torch.float32
              and tuple(img.shape) == (1, RESOLUTION, RESOLUTION, 3),
              f"image {tuple(img.shape)} {img.dtype}")
        check(bool(torch.isfinite(img).all()), "non-finite image")
        check(img.min().item() >= 0.0 and img.max().item() <= 1.0,
              "image outside [0, 1]")
        images.append(engine._to_uint8(img).int())
    total = fa.launches
    for i, (sec, n) in enumerate(zip(seconds, counts), 1):
        print(f"  request {i}: {sec:.3f} s/image, {n} flash_attention_hd"
              f" launches [{card}]", flush=True)
    check(all(n == LAUNCHES_PER_REQUEST for n in counts),
          f"launches per request {counts}, expected {LAUNCHES_PER_REQUEST}")
    check(bool((images[0] != images[1]).any()), "images 1 and 2 are identical")
    diff = (images[2] - images[0]).abs().max().item()
    check(diff <= 1, f"image 3 differs from image 1 by {diff} uint8 levels")
    print(f"  images 1/2 differ; image 3 within {diff} level(s) of image 1;"
          f" peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB", flush=True)
    return total


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs"
              " an NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    if not (ROOT / "cfgpp_tpu_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no cfgpp_tpu_torch package beside {__file__}; run it"
              " from a checkout of the repository", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(ROOT))
    from cfgpp_tpu_torch.engine import DiffusionEngine, ModelBundle
    from cfgpp_tpu_torch.kernels import build
    from cfgpp_tpu_torch.kernels import flash_attention as fa

    # the plain versions are f32 references: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_name_and_power()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    res = build.build_library("flash_attention")
    usage = [ln.strip() for ln in res.log.splitlines() if "registers" in ln]
    print(f"phase 1 ok: built {res.path.name} in {res.seconds:.2f} s; "
          f"{'; '.join(usage) or 'already built'}", flush=True)

    kernel = phase_kernels(fa, card)
    print(f"phase 2 ok: flash_attention_hd matches its plain version at"
          f" {len(ATTENTION_CASES)} shapes", flush=True)

    t0 = time.perf_counter()
    bundle = ModelBundle.random_init("sd15", seed=0, dtype=torch.bfloat16,
                                     device="cuda")
    engine = DiffusionEngine(bundle, "ddim_cfg++", nfe=NFE)
    torch.cuda.synchronize()
    print(f"  random sd15 bundle on the card in {time.perf_counter() - t0:.2f} s",
          flush=True)
    phase_models_vs_plain_attention(engine, fa)
    launches = phase_slice(engine, fa, card)
    print("phase 3 ok: SD-1.5 ddim_cfg++ slice, 3 requests", flush=True)

    print(json.dumps({"kernels": [{
        "name": "flash_attention_hd", "route": "cuda",
        "source": "cfgpp_tpu_torch/csrc/flash_attention.cu",
        "replaces": "cfgpp_tpu/kernels/flash_attention.py:378",
        "launches": launches, "max_abs_err": kernel["max_abs_err"],
        "ms": kernel["ms"], "plain_ms": kernel["plain_ms"],
        "ms_per": "request: sum over the slice's attention calls of calls x"
                  " time per call",
        "shapes": kernel["shapes"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
