"""Offline image-quality metrics CLI, counterpart of
``cfgpp_tpu/cli/calculate_metrics.py`` (parity: utils/calculate_metrics.py).

Walks two directories of same-named PNGs (or JPEGs) and reports paired
metrics (PSNR, MSE, LPIPS) plus distribution metrics (InceptionV3 FID,
CLIP-FID) and prompt-conditioned CLIP-score when the required weights are
supplied:

  python -m cfgpp_tpu_torch.cli.calculate_metrics --input_dir A --label_dir B \\
      --inception_ckpt pt_inception-2015-12-05.pth \\
      --vgg_ckpt vgg16.pth --lpips_ckpt lpips_vgg.pth \\
      --clip_ckpt clip_vit_l.safetensors --prompts prompts.txt \\
      --tokenizer_dir clip_tokenizer/

The towers run in f32 on ``--device`` (default ``cuda``; without a GPU
the CLI refuses to start rather than run on the CPU; ``--device cpu``
asks for the CPU), with torch's default TF32 settings, which are what a
pytorch-fid run on the same card gets.  Images decode on the host
(`utils.img.AsyncImageReader`: PNGs on threads, JPEGs in worker
processes).  It prints one JSON line with ``psnr``, ``mse``, ``n_pairs``,
``fid``, ``clip_fid``, ``clip_score`` and ``lpips``; a weight-gated metric
whose weights were not given is ``null`` and logged.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from cfgpp_tpu_torch.metrics import fid_from_features, mse, psnr
from cfgpp_tpu_torch.utils import get_logger
from cfgpp_tpu_torch.utils.img import AsyncImageReader


def _list_images(d: Path):
    return sorted(p for p in d.iterdir() if p.suffix.lower() in (".png", ".jpg", ".jpeg"))


def paired_metrics(input_dir: Path, label_dir: Path, logger):
    ins, labs = _list_images(input_dir), _list_images(label_dir)
    if len(ins) != len(labs):
        logger.warning("directory sizes differ: %d vs %d; using min",
                       len(ins), len(labs))
    n = min(len(ins), len(labs))
    mismatched = sum(a.name != b.name for a, b in zip(ins[:n], labs[:n]))
    if mismatched:
        # the reference pairs positionally over sorted listings
        # (utils/calculate_metrics.py:91-126); same-named dirs make the
        # pairing unambiguous, so a name mismatch usually means an off-by-
        # one listing and every downstream pair compares unrelated images
        logger.warning("%d/%d pairs have mismatched filenames — paired "
                       "metrics may be comparing unrelated images",
                       mismatched, n)
    psnrs, mses = [], []
    # interleaved A/B submission: the decoder pool decodes ahead while
    # Python computes the metrics — the data-loader analog of the
    # reference's DataLoader(num_workers=4)
    with AsyncImageReader([p for ab in zip(ins[:n], labs[:n]) for p in ab]) as r:
        for i, (a, b) in enumerate(zip(ins[:n], labs[:n])):
            ia = r.get(2 * i).astype(np.float32)
            ib = r.get(2 * i + 1).astype(np.float32)
            if ia.shape != ib.shape:
                raise ValueError(f"shape mismatch {a.name}: {ia.shape} vs {ib.shape}")
            psnrs.append(psnr(ia, ib, data_range=255.0))
            mses.append(mse(ia, ib))
    return {"psnr": float(np.mean(psnrs)), "mse": float(np.mean(mses)), "n_pairs": n}


def clip_features(paths, clip_ckpt: str, batch: int = 32,
                  device: str = "cuda") -> np.ndarray:
    """Image embeddings from the CLIP vision tower (for CLIP-FID / CLIP-score)."""
    from cfgpp_tpu_torch.metrics.clip_score import clip_image_features
    return clip_image_features([str(p) for p in paths], clip_ckpt, batch=batch,
                               device=device)


@torch.no_grad()
def lpips_metric(input_dir: Path, label_dir: Path, vgg_ckpt: str,
                 lpips_ckpt: str, batch: int = 8, device: str = "cuda") -> float:
    """Mean VGG-LPIPS over same-named pairs (reference: lpips net='vgg',
    utils/calculate_metrics.py:144-151)."""
    from cfgpp_tpu_torch.metrics.clip_score import _load_state
    from cfgpp_tpu_torch.metrics.lpips import LPIPS, convert_vgg16_lpips
    from cfgpp_tpu_torch.weights.convert import load_module_

    model = LPIPS().to(device).eval()
    load_module_(model, convert_vgg16_lpips(_load_state(vgg_ckpt),
                                            _load_state(lpips_ckpt)), "lpips")
    ins, labs = _list_images(input_dir), _list_images(label_dir)
    n = min(len(ins), len(labs))
    vals = []
    with AsyncImageReader(ins[:n]) as ra, AsyncImageReader(labs[:n]) as rb:
        for i in range(0, n, batch):
            j = min(i + batch, n)
            a = np.stack([ra.get(k) for k in range(i, j)]).astype(np.float32) \
                / 127.5 - 1.0
            b = np.stack([rb.get(k) for k in range(i, j)]).astype(np.float32) \
                / 127.5 - 1.0
            vals.append(model(torch.from_numpy(a).to(device),
                              torch.from_numpy(b).to(device)).cpu().numpy())
    return float(np.mean(np.concatenate(vals)))


def main(argv=None):
    parser = argparse.ArgumentParser(description="cfgpp_tpu_torch metrics")
    parser.add_argument("--input_dir", type=Path, required=True,
                        help="generated images")
    parser.add_argument("--label_dir", type=Path, required=True,
                        help="reference images")
    parser.add_argument("--inception_ckpt", type=str, default=None,
                        help="pytorch-fid InceptionV3 state dict (.pth or "
                             ".safetensors); enables standard FID")
    parser.add_argument("--clip_ckpt", type=str, default=None,
                        help="CLIP ViT-L weights; enables CLIP-FID (and "
                             "CLIP-score when --prompts is given)")
    parser.add_argument("--prompts", type=Path, default=None,
                        help="text file, one prompt per line aligned with "
                             "sorted --input_dir images; enables CLIP-score")
    parser.add_argument("--tokenizer_dir", type=str, default=None,
                        help="directory with the real CLIP vocab.json + "
                             "merges.txt (or set $CFGPP_TOKENIZER_DIR); "
                             "required for CLIP-score")
    parser.add_argument("--vgg_ckpt", type=str, default=None,
                        help="torchvision VGG16 state dict (LPIPS trunk)")
    parser.add_argument("--lpips_ckpt", type=str, default=None,
                        help="LPIPS linear-head state dict (lin{i}.model.1.weight)")
    parser.add_argument("--out", type=Path, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device the metric towers run on")
    args = parser.parse_args(argv)
    device = str(torch.device(args.device))
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is"
                           " available (pass --device cpu to run the metric"
                           " towers on the CPU)")

    logger = get_logger("metrics")
    results = paired_metrics(args.input_dir, args.label_dir, logger)

    if args.inception_ckpt:
        from cfgpp_tpu_torch.metrics.inception import inception_features
        a = inception_features([str(p) for p in _list_images(args.input_dir)],
                               args.inception_ckpt, device=device)
        b = inception_features([str(p) for p in _list_images(args.label_dir)],
                               args.inception_ckpt, device=device)
        results["fid"] = fid_from_features(a, b)
    else:
        results["fid"] = None
        logger.info("FID skipped: pass --inception_ckpt (pytorch-fid "
                    "pt_inception-2015-12-05 state dict)")

    input_clip_feats = None
    if args.clip_ckpt:
        input_clip_feats = clip_features(_list_images(args.input_dir),
                                         args.clip_ckpt, device=device)
        b = clip_features(_list_images(args.label_dir), args.clip_ckpt,
                          device=device)
        results["clip_fid"] = fid_from_features(input_clip_feats, b)
    else:
        results["clip_fid"] = None
        logger.info("CLIP-FID skipped: pass --clip_ckpt with CLIP weights")

    if args.prompts and args.clip_ckpt:
        from cfgpp_tpu_torch.metrics.clip_score import (
            clip_score_from_features, clip_text_features)
        prompts = [ln.strip() for ln in args.prompts.read_text().splitlines()
                   if ln.strip()]
        imgs = _list_images(args.input_dir)
        n = min(len(prompts), len(imgs))
        if len(prompts) != len(imgs):
            logger.warning("%d prompts vs %d images; scoring first %d",
                           len(prompts), len(imgs), n)
        t = clip_text_features(prompts[:n], args.clip_ckpt,
                               tokenizer_dir=args.tokenizer_dir, device=device)
        # image embeddings already computed for CLIP-FID: reuse, don't
        # re-run the vision tower over the same files
        v = input_clip_feats[:n]
        results["clip_score"] = clip_score_from_features(t, v)
    else:
        results["clip_score"] = None
        if args.prompts and not args.clip_ckpt:
            logger.info("CLIP-score skipped: --prompts given but no --clip_ckpt")

    if args.vgg_ckpt and args.lpips_ckpt:
        results["lpips"] = lpips_metric(args.input_dir, args.label_dir,
                                        args.vgg_ckpt, args.lpips_ckpt,
                                        device=device)
    else:
        results["lpips"] = None
        logger.info("LPIPS skipped: pass --vgg_ckpt (torchvision VGG16) and "
                    "--lpips_ckpt (LPIPS linear heads)")

    logger.info("metrics: %s", results)
    print(json.dumps(results))
    if args.out:
        args.out.write_text(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
