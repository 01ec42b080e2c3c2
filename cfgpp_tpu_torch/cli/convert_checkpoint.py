"""Convert a checkpoint into the port's native format.  Counterpart of
``cfgpp_tpu/cli/convert_checkpoint.py``.

Sources: an HF-layout directory (``unet/ vae/ text_encoder*/`` of
safetensors files) or a single-file SGM checkpoint (SDXL-Lightning).  The
output is the HF layout of `cfgpp_tpu_torch.weights.checkpoint.save_bundle`
(the UNet in ``--dtype``, the VAE and text encoders in f32), which
``ModelBundle.from_pretrained`` and ``--ckpt_dir`` read.

  python -m cfgpp_tpu_torch.cli.convert_checkpoint --model sdxl \\
      --src /ckpts/sdxl_hf --dst /ckpts/sdxl_native
  python -m cfgpp_tpu_torch.cli.convert_checkpoint --model sdxl_lightning \\
      --single_file ckpt/sdxl_lightning_4step.safetensors --dst out/
"""

from __future__ import annotations

import argparse

import torch

from cfgpp_tpu_torch.cli.common import MODELS


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="cfgpp_tpu_torch checkpoint converter")
    parser.add_argument("--model", type=str, required=True, choices=MODELS)
    parser.add_argument("--src", type=str, default=None,
                        help="HF-layout checkpoint directory")
    parser.add_argument("--single_file", type=str, default=None,
                        help="single-file SGM safetensors checkpoint")
    parser.add_argument("--dst", type=str, required=True,
                        help="output directory (the port's native format)")
    parser.add_argument("--dtype", type=str, default="bfloat16",
                        choices=("bfloat16", "float32"))
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device the bundle is assembled on")
    args = parser.parse_args(argv)
    if bool(args.src) == bool(args.single_file):
        parser.error("provide exactly one of --src / --single_file")

    from cfgpp_tpu_torch.engine import ModelBundle
    from cfgpp_tpu_torch.weights.checkpoint import save_bundle

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    if args.single_file:
        bundle = ModelBundle.from_single_file(args.single_file, args.model,
                                              dtype=dtype, device=args.device)
    else:
        bundle = ModelBundle.from_pretrained(args.src, args.model, dtype=dtype,
                                             device=args.device)
    save_bundle(bundle, args.dst)
    print(f"saved native checkpoint to {args.dst}")


if __name__ == "__main__":
    main()
