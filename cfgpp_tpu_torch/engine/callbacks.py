"""Per-step callbacks, counterpart of ``cfgpp_tpu/engine/callbacks.py``.

The reference's callback registry (``utils/callback_util.py:6-75``): a
named callback receives ``(step, t, {"z0t", "zt", "decode"})`` and returns
the (possibly changed) kwargs.  ``DiffusionEngine.sample`` replays
callbacks over the kept trajectory after the loop, or runs them inside the
loop with ``unrolled=True`` (what they return then feeds the next step).
``decode`` gives float32 images in [0, 1] on the device; the draw
callbacks move them to the host and save them as PNG.
"""

from __future__ import annotations

from pathlib import Path

from cfgpp_tpu_torch.utils.img import save_image

_CALLBACK_REGISTRY: dict = {}


def register_callback(name):
    def wrapper(cls):
        if name in _CALLBACK_REGISTRY:
            raise KeyError(
                f"duplicate callback name {name!r} "
                f"(taken by {_CALLBACK_REGISTRY[name].__name__})")
        _CALLBACK_REGISTRY[name] = cls
        return cls
    return wrapper


def get_callback(name, **kwargs):
    try:
        cls = _CALLBACK_REGISTRY[name]
    except KeyError:
        known = ", ".join(sorted(_CALLBACK_REGISTRY))
        raise KeyError(f"unknown callback {name!r}; available: {known}") from None
    return cls(**kwargs)


def available_callbacks() -> list:
    return sorted(_CALLBACK_REGISTRY)


class DiffusionCallback:
    """Frequency-gated callback: fires at step 0 and wherever
    (step + 1) % frequency == 0 (``utils/callback_util.py:31-34``)."""

    def __init__(self, frequency: int, workdir: Path):
        if frequency <= 0:
            raise ValueError("Frequency must be a positive integer")
        self.frequency = frequency
        self.workdir = Path(workdir)

    def __call__(self, step, t, callback_kwargs):
        if (step + 1) % self.frequency == 0 or step == 0:
            return self.callback(step, t, callback_kwargs)
        return callback_kwargs

    def callback(self, step, t, callback_kwargs):
        raise NotImplementedError


class _DrawLatent(DiffusionCallback):
    latent_key: str
    subdir: str
    prefix: str

    def __init__(self, frequency: int, workdir: Path):
        super().__init__(frequency, workdir)
        self.workdir.joinpath(f"record/{self.subdir}").mkdir(parents=True,
                                                             exist_ok=True)

    def callback(self, step, t, callback_kwargs):
        z = callback_kwargs[self.latent_key]
        img = callback_kwargs["decode"](z).float().cpu().numpy()
        indices = callback_kwargs.get("sample_indices")
        if indices is not None and len(indices) == img.shape[0]:
            # a batch of sample_batch: one record/ tree per sample, keyed by
            # its global prompt index (the batched form of the reference's
            # per-prompt record dirs, examples/text_to_mscoco.py:43-45)
            for gi, im in zip(indices, img):
                save_image(im, self.workdir / f"record/{int(gi):05d}/"
                           f"{self.subdir}/{self.prefix}_{int(t)}.png")
        else:
            save_image(img, self.workdir /
                       f"record/{self.subdir}/{self.prefix}_{int(t)}.png")
        return callback_kwargs


@register_callback("draw_tweedie")
class DrawTweedieCallback(_DrawLatent):
    """Decode and save the Tweedie estimate z0t at each firing step."""
    latent_key, subdir, prefix = "z0t", "tweedie", "x0"


@register_callback("draw_noisy")
class DrawNoisyCallback(_DrawLatent):
    """Decode and save the running noisy latent zt at each firing step."""
    latent_key, subdir, prefix = "zt", "noisy", "xt"


class ComposeCallback(DiffusionCallback):
    """The named callbacks in order, each with its own frequency gate."""

    def __init__(self, workdir, callbacks, frequency: int = 5):
        super().__init__(frequency, workdir)
        self.callbacks = [get_callback(n, workdir=Path(workdir),
                                       frequency=frequency)
                          for n in callbacks]

    def __call__(self, step, t, callback_kwargs):
        for cb in self.callbacks:
            callback_kwargs = cb(step, t, callback_kwargs)
        return callback_kwargs
