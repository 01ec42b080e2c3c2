from cfgpp_tpu_torch.engine.bundle import ModelBundle
from cfgpp_tpu_torch.engine.pipeline import DiffusionEngine

__all__ = ["DiffusionEngine", "ModelBundle"]
