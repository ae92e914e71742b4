from .ensemble import self_ensemble  # noqa: F401
from .seam import seam_stitch  # noqa: F401
from .tiled import sr_full_image, sr_grid_patches, sr_overlap_image  # noqa: F401
