from cfgpp_tpu_torch.metrics.clip_score import (clip_score,
                                                clip_score_from_features)
from cfgpp_tpu_torch.metrics.fid import (compute_stats, fid_from_features,
                                         frechet_distance)
from cfgpp_tpu_torch.metrics.functional import mnc, mse, psnr
from cfgpp_tpu_torch.metrics.inception import (InceptionV3Features,
                                               convert_inception)
from cfgpp_tpu_torch.metrics.lpips import LPIPS, convert_vgg16_lpips

__all__ = ["clip_score", "clip_score_from_features",
           "compute_stats", "fid_from_features", "frechet_distance",
           "InceptionV3Features", "convert_inception",
           "LPIPS", "convert_vgg16_lpips",
           "mnc", "mse", "psnr"]
