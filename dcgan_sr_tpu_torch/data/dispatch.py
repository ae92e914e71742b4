"""Dataset-name dispatch (port of dcgan_sr_tpu/data/dispatch.py) with the
reference's semantics (data/data.lua:16-26):
'folder' and 'imagenet' share the folder donkey; 'lsun' names a donkey file
that does not exist in the tree; anything else is `error('Unknown dataset')`.
'indexed' and 'synthetic' are this framework's additional first-class paths.
"""

from __future__ import annotations

from .folder import FolderDataset
from .indexed import IndexedCelebA
from .synthetic import SyntheticImages


def make_dataset(name, *, root=None, load_size=96, fine_size=64, nc=3,
                 n_threads=4, seed=1234, **kw):
    if name in ("folder", "imagenet"):
        return FolderDataset(root, load_size, fine_size, nc, **kw)
    if name == "indexed":
        return IndexedCelebA(root, fine_size, nc=nc, n_threads=n_threads)
    if name == "synthetic":
        return SyntheticImages(fine_size, nc=nc, seed=seed)
    if name in ("lsun", "rrrrr"):
        raise NotImplementedError(
            f"dataset '{name}': the reference names a donkey file for it but "
            "does not ship one (data/data.lua:19-23)")
    raise ValueError(f"Unknown dataset: {name}")
