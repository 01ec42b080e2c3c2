from cfgpp_tpu_torch.engine.bundle import ModelBundle
from cfgpp_tpu_torch.engine.callbacks import (ComposeCallback, get_callback,
                                              register_callback)
from cfgpp_tpu_torch.engine.pipeline import DiffusionEngine

__all__ = ["ModelBundle", "DiffusionEngine", "ComposeCallback", "get_callback",
           "register_callback"]
