"""Text-to-image CLI, counterpart of ``cfgpp_tpu/cli/text_to_img.py``.

Run: ``python -m cfgpp_tpu_torch.cli.text_to_img --model sd15 --method
ddim_cfg++ --cfg_guidance 0.6 --NFE 50 --prompt "..." --device cuda``
(``--model sd21_v`` for SD-2.1 at 768^2, v-prediction).
Writes ``<workdir>/result/generated.png``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from cfgpp_tpu_torch.cli.common import add_common_args, build_engine
from cfgpp_tpu_torch.utils.img import save_image


def main(argv=None):
    parser = argparse.ArgumentParser(description="cfgpp_tpu_torch text-to-image")
    add_common_args(parser, default_method="ddim", default_nfe=50)
    args = parser.parse_args(argv)

    engine = build_engine(args)
    result = engine.sample(prompt=[args.null_prompt, args.prompt],
                           cfg_guidance=args.cfg_guidance, seed=args.seed,
                           resolution=args.resolution)
    out = Path(args.workdir or "workdir/t2i") / "result" / "generated.png"
    save_image(result.cpu().numpy(), out, normalize_img=True)
    print(f"saved {out}")


if __name__ == "__main__":
    main()
