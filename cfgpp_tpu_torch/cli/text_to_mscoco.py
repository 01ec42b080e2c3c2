"""MS-COCO eval generation CLI, counterpart of
``cfgpp_tpu/cli/text_to_mscoco.py``.

    python -m cfgpp_tpu_torch.cli.text_to_mscoco --model sdxl \\
        --method ddim_cfg++ --cfg_guidance 0.6 --batch_size 8 \\
        --prompt_dir coco_v2.txt --workdir out [--resume]
    torchrun --nproc_per_node N -m cfgpp_tpu_torch.cli.text_to_mscoco ...

The prompts (one a line) are cut into global batches of ``--batch_size``;
each runs as one ``DiffusionEngine.sample_batch`` and image i lands in
``<workdir>/{i:05d}.png``.  Each sample's random streams are keyed by its
global prompt index, so image i does not depend on the batch size or on
the process that drew it.  The tail batch is padded with "" to the full
batch, and no file is written for a padded slot.  ``--resume`` skips a
batch whose PNGs all exist; ``--callbacks`` writes one
``record/<global_idx>/`` tree per sample.  ``generation_stats.json``
counts only the images on disk.

The device-to-host copy overlaps the next batch: a batch's uint8 images
(converted on the device) are copied into pinned host memory without
blocking, a CUDA event is recorded after the copy, and the PNG writer's
threads wait on that event before they encode, while this thread enqueues
the next batch.  Nothing on the loop synchronizes the device.

One process per GPU (``cfgpp_tpu_torch.parallel``): under torchrun, rank r
runs on ``cuda:LOCAL_RANK`` and takes its contiguous ``batch_size /
world`` share of every global batch, where the JAX CLI shards the batch
over its device mesh; as there, this applies when ``batch_size`` divides
by the number of ranks and there is more than one, and ``--no_mesh`` turns
it off (rank 0 then generates every image, the other ranks none).  The one
difference from the single-process JAX CLI: with the batch split over
ranks, each rank writes ``generation_stats.rank{r}.json`` and prints its
own rate.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from cfgpp_tpu_torch.cli.common import add_common_args, build_engine, parse_args
from cfgpp_tpu_torch.engine.callbacks import ComposeCallback
from cfgpp_tpu_torch.parallel import data_parallel, shard_indices
from cfgpp_tpu_torch.utils.img import AsyncPngWriter
from cfgpp_tpu_torch.utils.log import create_workdir


def read_prompts(path: str, limit: int) -> list:
    """The non-empty lines of ``path``, stripped, at most ``limit``."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(line)
    return out[:limit]


def to_host(u8: torch.Tensor):
    """(host tensor, event or None): a device batch copied into pinned
    host memory without blocking, with the CUDA event recorded after the
    copy; a CPU batch as it is."""
    if u8.device.type != "cuda":
        return u8, None
    host = torch.empty(u8.shape, dtype=u8.dtype, pin_memory=True)
    host.copy_(u8, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(u8.device))
    return host, ready


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="cfgpp_tpu_torch MS-COCO generation")
    add_common_args(parser, default_method="ddim", default_nfe=50)
    parser.add_argument("--prompt_dir", type=str, required=True,
                        help="text file, one prompt per line (e.g. coco_v2.txt)")
    parser.add_argument("--num_prompts", type=int, default=10000)
    parser.add_argument("--batch_size", type=int, default=8,
                        help="global batch; split over the ranks")
    parser.add_argument("--no_mesh", action="store_true",
                        help="do not split batches over the ranks")
    parser.add_argument("--resume", action="store_true",
                        help="skip batches whose output PNGs all exist")
    parser.add_argument("--callbacks", type=str, nargs="*", default=None,
                        help="per-step visual callbacks, e.g. draw_noisy "
                             "draw_tweedie (the reference wires both at "
                             "frequency 1 into eval generation, "
                             "examples/text_to_mscoco.py:43-45); images land "
                             "in <workdir>/record/<global_idx>/...")
    parser.add_argument("--callback_frequency", type=int, default=1)
    args = parse_args(parser, argv)

    dp = data_parallel()
    if args.device == "cuda":
        args.device = str(dp.device)
        torch.cuda.set_device(dp.device)
    sharded = not args.no_mesh and dp.world > 1 \
        and args.batch_size % dp.world == 0
    if dp.world > 1 and not sharded and dp.rank != 0:
        print(f"rank {dp.rank}: batches are not split over the ranks"
              f" (--batch_size {args.batch_size}, {dp.world} ranks"
              f"{', --no_mesh' if args.no_mesh else ''}); rank 0 generates"
              " every image")
        return
    if sharded:
        print(f"rank {dp.rank} of {dp.world} on {args.device}: its"
              f" {args.batch_size // dp.world} of every {args.batch_size}"
              " prompts")

    workdir = create_workdir(args.workdir or "workdir/mscoco")
    prompts = read_prompts(args.prompt_dir, args.num_prompts)
    engine = build_engine(args)
    callback = None
    if args.callbacks:
        callback = ComposeCallback(workdir=workdir, callbacks=args.callbacks,
                                   frequency=args.callback_frequency)

    bs = args.batch_size
    t0 = time.time()
    submitted = 0
    with AsyncPngWriter(n_threads=8) as writer:
        for start in range(0, len(prompts), bs):
            chunk = prompts[start:start + bs]
            paths = [workdir / f"{i:05d}.png"
                     for i in range(start, start + len(chunk))]
            if args.resume and all(p.exists() for p in paths):
                continue
            # the tail batch is padded to the full batch; its padded slots
            # are generated (keyed by their own indices) but not written
            run_prompts = chunk + [""] * (bs - len(chunk))
            run_indices = list(range(start, start + bs))
            if sharded:
                run_indices = shard_indices(run_indices, dp.rank, dp.world)
            u8 = engine.sample_batch(
                null_prompt=args.null_prompt,
                prompts=[run_prompts[i - start] for i in run_indices],
                cfg_guidance=args.cfg_guidance, seed=args.seed,
                resolution=args.resolution, sample_indices=run_indices,
                as_numpy=False, to_uint8=True, callback_fn=callback)
            host, ready = to_host(u8)
            for j, i in enumerate(run_indices):
                if i < start + len(chunk):
                    writer.submit(workdir / f"{i:05d}.png", host[j].numpy(),
                                  ready=ready)
                    submitted += 1
            if submitted:
                rate = submitted / (time.time() - t0)
                print(f"[{submitted}/{len(prompts)}] {rate:.3f} img/s",
                      flush=True)
        failed = writer.wait()
        if failed:
            print(f"WARNING: {failed} image writes failed, the first:"
                  f" {writer.errors[0][0]}: {writer.errors[0][1]!r}")

    done = submitted - failed      # count only the images on disk
    seconds = time.time() - t0
    stats = {"num_images": done, "seconds": seconds,
             "images_per_sec": done / max(seconds, 1e-9)}
    name = (f"generation_stats.rank{dp.rank}.json" if sharded
            else "generation_stats.json")
    with open(workdir / name, "w") as f:
        json.dump(stats, f)
    print(json.dumps(stats))


if __name__ == "__main__":
    main()
