"""Text-to-image CLI, counterpart of ``cfgpp_tpu/cli/text_to_img.py``.

Run: ``python -m cfgpp_tpu_torch.cli.text_to_img --model sd15 --method
ddim_cfg++ --cfg_guidance 0.6 --NFE 50 --prompt "..." --device cuda``
(``--model sd21_v`` for SD-2.1 at 768^2, v-prediction; ``--model sdxl
--method dpm++_2m_cfgpp --cfg_guidance 5 --NFE 25`` for SDXL at 1024^2,
with ``--prompt_2``, ``--null_prompt_2`` and ``--clip_skip``; ``--model
sdxl_lightning --ckpt_dir D --light_ckpt F --method ddim_cfg++_lightning
--NFE 4 --cfg_guidance 1`` for SDXL-Lightning).  Weights come from
``--ckpt_dir`` and ``--light_ckpt`` (see ``cli/common.py``), else from a
seed.  Writes ``<workdir>/result/generated.png``; with ``--callbacks
draw_tweedie draw_noisy`` also the decoded z0t / zt of every
``--callback_frequency``-th step under ``<workdir>/record/``; with
``--profile_dir D`` a ``torch.profiler`` trace of the request (`sample`)
as a Chrome trace file under D.
"""

from __future__ import annotations

import argparse

from cfgpp_tpu_torch.cli.common import (add_common_args, build_engine,
                                        maybe_profile, parse_args)
from cfgpp_tpu_torch.engine.callbacks import ComposeCallback
from cfgpp_tpu_torch.utils.img import save_image
from cfgpp_tpu_torch.utils.log import create_workdir


def main(argv=None):
    parser = argparse.ArgumentParser(description="cfgpp_tpu_torch text-to-image")
    add_common_args(parser, default_method="ddim", default_nfe=50)
    parser.add_argument("--callbacks", type=str, nargs="*", default=None,
                        help="e.g. draw_noisy draw_tweedie")
    parser.add_argument("--callback_frequency", type=int, default=1)
    parser.add_argument("--prompt_2", type=str, default=None,
                        help="SDXL second-encoder prompt (defaults to --prompt)")
    parser.add_argument("--null_prompt_2", type=str, default=None)
    parser.add_argument("--clip_skip", type=int, default=None)
    args = parse_args(parser, argv)

    workdir = create_workdir(args.workdir or "workdir/t2i")
    callback = None
    if args.callbacks:
        callback = ComposeCallback(workdir=workdir, callbacks=args.callbacks,
                                   frequency=args.callback_frequency)

    engine = build_engine(args)
    prompt_2 = None
    if args.prompt_2 is not None or args.null_prompt_2 is not None:
        prompt_2 = [args.null_prompt_2 if args.null_prompt_2 is not None
                    else args.null_prompt,
                    args.prompt_2 if args.prompt_2 is not None else args.prompt]
    with maybe_profile(args):
        result = engine.sample(prompt=[args.null_prompt, args.prompt],
                               prompt_2=prompt_2,
                               cfg_guidance=args.cfg_guidance, seed=args.seed,
                               resolution=args.resolution,
                               callback_fn=callback, clip_skip=args.clip_skip)
    out = workdir / "result" / "generated.png"
    save_image(result.cpu().numpy(), out, normalize_img=True)
    print(f"saved {out}")


if __name__ == "__main__":
    main()
