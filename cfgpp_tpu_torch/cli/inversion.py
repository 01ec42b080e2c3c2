"""DDIM-inversion / reconstruction CLI, counterpart of
``cfgpp_tpu/cli/inversion.py`` (examples/inversion.py).

Run: ``python -m cfgpp_tpu_torch.cli.inversion --img_path in.png --prompt
"..." --method ddim_inversion_cfg++ --cfg_guidance 0.6 --NFE 10``.  Loads a
PNG, inverts it to zT with the chosen inversion solver, resamples, and
writes ``<workdir>/result/reconstruct.png``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from cfgpp_tpu_torch.cli.common import add_common_args, build_engine, parse_args
from cfgpp_tpu_torch.utils.img import load_image, save_image


def main(argv=None):
    parser = argparse.ArgumentParser(description="cfgpp_tpu_torch inversion")
    add_common_args(parser, default_method="ddim_inversion_cfg++", default_nfe=10)
    parser.add_argument("--img_path", type=str, required=True,
                        help="8-bit greyscale, RGB or RGBA PNG")
    parser.add_argument("--img_size", type=int, default=512)
    parser.add_argument("--latent_init", type=str, default="ddim",
                        choices=("ddim", "npi"),
                        help="ddim: invert with the null prompt; npi: "
                             "negative-prompt inversion (cond prompt as "
                             "null, w=1; latent_diffusion.py:195-197)")
    parser.set_defaults(null_prompt="")
    args = parse_args(parser, argv)

    workdir = Path(args.workdir or "workdir/inversion")
    img = load_image(args.img_path, size=args.img_size, centered=True)
    engine = build_engine(args)
    result = engine.sample(prompt=[args.null_prompt, args.prompt],
                           cfg_guidance=args.cfg_guidance, seed=args.seed,
                           resolution=args.img_size, src_img=img,
                           latent_init=args.latent_init)
    out = workdir / "result" / "reconstruct.png"
    save_image(result.cpu().numpy(), out, normalize_img=True)
    print(f"saved {out}")


if __name__ == "__main__":
    main()
