from .ops import (box_downsample2, crop_hflip_at,  # noqa: F401
                  normalize_pm1, resize_bilinear, rgb2gray, to_display)
from .patches import (extract_grid_patches,  # noqa: F401
                      extract_overlap_patches, reassemble_grid_patches,
                      stitch_overlap_naive)
