"""Shared CLI plumbing: bundle construction + engine creation.

Counterpart of ``cfgpp_tpu/cli/common.py`` for the models the port runs
(``sdxl_lightning`` comes with ``--light_ckpt``).  Weights are seeded random
(``--ckpt_dir`` comes with ``from_pretrained``).  ``--method`` takes the
solvers of the chosen model's family (`parse_args` checks it).
"""

from __future__ import annotations

import argparse

import torch

from cfgpp_tpu_torch.configs import get_bundle_config
from cfgpp_tpu_torch.engine import DiffusionEngine, ModelBundle
from cfgpp_tpu_torch.solvers.registry import list_solvers

SD_MODELS = ("sd15", "sd20", "sd21", "sd21_v", "tiny_sd")   # the JAX SD_MODELS
SDXL_MODELS = ("sdxl", "tiny_sdxl")
MODELS = SD_MODELS + SDXL_MODELS

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
                             f"{list_solvers('sdxl')}")
    parser.add_argument("--model", type=str, default="sd15", choices=MODELS)
    parser.add_argument("--NFE", type=int, default=default_nfe)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--resolution", type=int, default=None)
    parser.add_argument("--dtype", type=str, default="bfloat16",
                        choices=("bfloat16", "float32"),
                        help="float32 runs on the card too: the f32 "
                             "attention kernel, and with --quant the int8 "
                             "kernels on f32 activations")
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
    family = get_bundle_config(args.model).family
    if args.method not in list_solvers(family):
        parser.error(f"argument --method: {args.method!r} is no {family} "
                     f"solver (choose from {list_solvers(family)})")
    return args


def build_engine(args) -> DiffusionEngine:
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    bundle = ModelBundle.random_init(args.model, seed=0, dtype=dtype,
                                     device=args.device)
    if args.quant:
        bundle = bundle.quantized(mode=args.quant)
    return DiffusionEngine(bundle, solver=args.method, nfe=args.NFE)
