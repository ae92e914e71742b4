from .ops import (box_downsample2, normalize_pm1,  # noqa: F401
                  resize_bilinear, rgb2gray)
