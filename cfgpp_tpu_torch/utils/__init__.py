from cfgpp_tpu_torch.utils.img import (fft2d, ifft2d, load_image, normalize,
                                       save_image, to_np)
from cfgpp_tpu_torch.utils.log import (create_workdir, get_logger, make_gif,
                                       save_floats, set_seed)

__all__ = [
    "fft2d", "ifft2d", "load_image", "normalize", "save_image", "to_np",
    "create_workdir", "get_logger", "make_gif", "save_floats", "set_seed",
]
