from .dispatch import make_dataset  # noqa: F401
from .folder import FolderDataset  # noqa: F401
from .indexed import IndexedCelebA, celeba_path  # noqa: F401
from .prefetch import PrefetchLoader  # noqa: F401
from .synthetic import SyntheticImages, TexturedImages  # noqa: F401
