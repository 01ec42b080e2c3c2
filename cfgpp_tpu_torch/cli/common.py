"""Shared CLI plumbing: bundle construction + engine creation.

Counterpart of ``cfgpp_tpu/cli/common.py``: every model of the JAX CLI,
and SD3 (``SD3_MODELS``, seeded random weights only).
Weights: ``--ckpt_dir`` (an HF-layout safetensors directory, e.g. one that
``cfgpp_tpu_torch.cli.convert_checkpoint`` wrote) or seeded random ones;
``--light_ckpt`` overlays a single-file SGM checkpoint (SDXL-Lightning) on
either, as the JAX CLI does; then ``--quant``.  ``--method`` takes the
solvers of the chosen model's family (`parse_args` checks it).
"""

from __future__ import annotations

import argparse

import torch

from cfgpp_tpu_torch.configs import get_bundle_config
from cfgpp_tpu_torch.engine import DiffusionEngine, ModelBundle
from cfgpp_tpu_torch.solvers.registry import list_solvers
from cfgpp_tpu_torch.weights.single_file import load_single_file

SD_MODELS = ("sd15", "sd20", "sd21", "sd21_v", "tiny_sd")   # the JAX SD_MODELS
SDXL_MODELS = ("sdxl", "sdxl_lightning", "tiny_sdxl")
# `configs_sd3.SD3_PRESETS`, named here so that the SD / SDXL commands do
# not import the SD3 modules
SD3_MODELS = ("sd35_large", "tiny_sd3")
MODELS = SD_MODELS + SDXL_MODELS + SD3_MODELS

# Reference default negative prompt (examples/text_to_img.py:17).
DEFAULT_NULL_PROMPT = ("low quality,jpeg artifacts,blurry,poorly drawn,ugly,"
                       "worst quality,")


def add_common_args(parser: argparse.ArgumentParser, default_method: str = "ddim",
                    default_nfe: int = 50) -> None:
    parser.add_argument("--workdir", type=str, required=False)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device the models run on")
    parser.add_argument("--null_prompt", type=str, default=DEFAULT_NULL_PROMPT)
    parser.add_argument("--prompt", type=str, default="")
    parser.add_argument("--cfg_guidance", type=float, default=7.5)
    parser.add_argument("--method", type=str, default=default_method,
                        help="a solver of the model's family: sd "
                             f"{list_solvers('sd')}; sdxl "
                             f"{list_solvers('sdxl')}; sd3 "
                             f"{list_solvers('sd3')}")
    parser.add_argument("--model", type=str, default="sd15", choices=MODELS)
    parser.add_argument("--NFE", type=int, default=default_nfe)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--ckpt_dir", type=str, default=None,
                        help="HF-layout safetensors checkpoint directory "
                             "(unet/ vae/ text_encoder*/); omitted -> seeded "
                             "random weights")
    parser.add_argument("--light_ckpt", type=str, default=None,
                        help="single-file SGM-layout safetensors checkpoint "
                             "(SDXL-Lightning) laid over the --ckpt_dir or "
                             "random bundle")
    parser.add_argument("--resolution", type=int, default=None)
    parser.add_argument("--dtype", type=str, default="bfloat16",
                        choices=("bfloat16", "float32"),
                        help="float32 runs on the card too: the f32 "
                             "attention kernel, and with --quant the int8 "
                             "kernels on f32 activations; it turns TF32 off")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="capture a torch.profiler trace of the run "
                             "(host operators and CUDA kernels) into this "
                             "directory as a Chrome trace (*.pt.trace.json)")
    parser.add_argument("--quant", type=str, default=None,
                        choices=("dense", "all"),
                        help="opt-in int8 W8A8 UNet (numerics differ from "
                             "the exact bf16 path): 'dense' quantizes the "
                             "transformer projections through the fused "
                             "int8 matmul kernels; 'all' also the resnet "
                             "and upsampler convs (int8_conv3x3) and the "
                             "self-attention score")


def parse_args(parser: argparse.ArgumentParser, argv=None):
    """``parser.parse_args``, then ``--method`` checked against the solvers
    of ``--model``'s family."""
    args = parser.parse_args(argv)
    family = ("sd3" if args.model in SD3_MODELS
              else get_bundle_config(args.model).family)
    if args.method not in list_solvers(family):
        parser.error(f"argument --method: {args.method!r} is no {family} "
                     f"solver (choose from {list_solvers(family)})")
    return args


def maybe_profile(args):
    """Context manager: a ``torch.profiler`` trace when --profile_dir is
    set."""
    import contextlib

    if getattr(args, "profile_dir", None):
        from cfgpp_tpu_torch.utils.profiling import trace
        return trace(args.profile_dir)
    return contextlib.nullcontext()


def f32_without_tf32(dtype: str) -> None:
    """Under ``--dtype float32``, turn TF32 off for cuDNN's convs (and
    cuBLAS's matmuls, off by default): torch's default cuDNN TF32 rounds
    every f32 conv's inputs to 10 mantissa bits, which moved an f32 SD-1.5
    UNet call and VAE encode by rel-L2 1.2e-3 on an NVIDIA H100 80GB HBM3
    at 700 W, outside the f32 path's 1e-3 bound (``chip_smoke.py`` phase 6).  Under bf16 torch's
    defaults stay."""
    if dtype == "float32":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def build_engine(args) -> DiffusionEngine:
    """The JAX CLI's order (``cfgpp_tpu/cli/common.py:67-89``): the base
    bundle from ``--ckpt_dir`` or seeded random weights, the
    ``--light_ckpt`` single file over it, then ``--quant``.  ``--dtype
    float32`` also turns TF32 off (`f32_without_tf32`)."""
    f32_without_tf32(args.dtype)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    if args.model in SD3_MODELS:
        return build_sd3_engine(args, dtype)
    if args.ckpt_dir:
        bundle = ModelBundle.from_pretrained(args.ckpt_dir, args.model,
                                             dtype=dtype, device=args.device)
    else:
        bundle = ModelBundle.random_init(args.model, seed=0, dtype=dtype,
                                         device=args.device)
    if args.light_ckpt:
        bundle = load_single_file(bundle, args.light_ckpt)
    if args.quant:
        bundle = bundle.quantized(mode=args.quant)
    return DiffusionEngine(bundle, solver=args.method, nfe=args.NFE)


def build_sd3_engine(args, dtype: torch.dtype):
    """SD3 (``--model sd35_large``): seeded random weights (no checkpoint
    loader yet), no int8 mode."""
    refused = [f for f in ("ckpt_dir", "light_ckpt", "quant")
               if getattr(args, f, None)]
    if refused:
        raise SystemExit(f"--model {args.model}: SD3 takes no "
                         + ", ".join(f"--{f}" for f in refused))
    from cfgpp_tpu_torch.engine.sd3 import SD3Bundle, SD3Engine
    bundle = SD3Bundle.random_init(args.model, seed=0, dtype=dtype,
                                   device=args.device)
    return SD3Engine(bundle, solver=args.method, nfe=args.NFE)
