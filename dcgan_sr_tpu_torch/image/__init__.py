from .ops import (box_downsample2, normalize_pm1,  # noqa: F401
                  resize_bilinear, rgb2gray)
from .patches import (extract_grid_patches,  # noqa: F401
                      extract_overlap_patches, reassemble_grid_patches,
                      stitch_overlap_naive)
