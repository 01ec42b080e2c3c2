from cfgpp_tpu_torch.utils.img import load_image, normalize, save_image
from cfgpp_tpu_torch.utils.log import (create_workdir, get_logger, save_floats,
                                       set_seed)

__all__ = ["load_image", "normalize", "save_image", "create_workdir",
           "get_logger", "save_floats", "set_seed"]
