"""cfgpp_tpu_torch — the PyTorch / CUDA port of cfgpp_tpu for NVIDIA Hopper.

Module paths mirror ``cfgpp_tpu/``, whose JAX code is the reference each
module is tested against.  The port imports torch and never jax, and
nothing of the JAX package: ``configs``, ``schedules.ddim``,
``schedules.karras`` and ``weights.tokenizer`` are copies, held equal to the JAX package's by
``tests/test_torch_port_copies.py``.

Layer map (bottom-up):
  configs     model architecture configs (copy)
  csrc/       hand-written CUDA C++ kernels (sm_90a), built at first use
  kernels/    their wrappers (kernel on a CUDA tensor, plain PyTorch on a
              CPU tensor), the nvcc build and the ctypes loader
  models/     CLIP text encoder, UNet2DCondition (SD-1.5, SD-2.x and SDXL
              layouts), VAE
  weights/    safetensors I/O; HF-layout and SGM single-file checkpoints
              and the native one -> the port's modules; JAX parameter
              trees -> the port's state dicts; the CLIP tokenizer (copy)
  schedules/  DDIM noise-schedule tables and Karras sigmas (copies)
  solvers/    the SD and SDXL solvers' plans, steps, sampling and
              inversion loops
  engine/     ModelBundle + DiffusionEngine (tokenize -> encode -> solve ->
              decode; sample and the batched sample_batch) + callbacks
  parallel/   one process per GPU: the rank's share of a global batch
  utils/      PNG output (also on writer threads) and input; logging and
              workdirs; roofline bounds of the kernels' work
  tools/      A/B timing and profiling scripts; the SGM inverse map
  cli/        text_to_img, inversion, text_to_mscoco, convert_checkpoint
"""

__version__ = "0.1.0"
from cfgpp_tpu_torch.engine import (ComposeCallback, DiffusionEngine,
                                    ModelBundle, get_callback,
                                    register_callback)

__all__ = ["ModelBundle", "DiffusionEngine", "ComposeCallback", "get_callback",
           "register_callback"]
