from .psnr_ssim import (cal_mse_hw, cal_mse_quarter, cal_psnr,  # noqa: F401
                        cal_psnr_batch, cal_ssim, cal_ssim_batch)
