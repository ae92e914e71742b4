"""Config system: the seven reference variants as named configs + env-var overrides.

The PyTorch port's own copy of dcgan_sr_tpu/core/config.py: the same fields,
defaults and override rules, kept field for field so a config built here
equals the JAX package's (tests/test_torch_config.py).  The port imports
nothing of the JAX package, so it carries this module itself.

The reference configures each script with an `opt` table whose defaults are
overridden by one line of env parsing
(``for k,v in pairs(opt) do opt[k] = tonumber(os.getenv(k)) or os.getenv(k) or opt[k] end``,
reference train.lua:26, train-gray-3.lua:21).  We reproduce those keys, defaults
and the override semantics exactly, one named config per entry script.

Reference config sources:
  rgb-full                -> train.lua:9-22
  gray                    -> train-gray.lua:9-22
  gray-2                  -> train-gray-2.lua:7-17  (NOTE: no env override in ref)
  gray-3                  -> train-gray-3.lua:9-18
  gray-patch              -> train-gray-patch.lua:9-21
  gray-patch-batch        -> train-gray-patch-batch.lua:9-21
  gray-patch-batch-overlap-> train-gray-patch-batch-overlap.lua:11-28
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import ClassVar, Optional


@dataclasses.dataclass
class Config:
    # ---- keys mirroring the reference `opt` table -------------------------
    variant: str = "gray-3"
    dataset: str = "folder"        # folder | indexed | synthetic
    batchSize: int = 100
    loadSize: int = 96
    fineSize: int = 64
    ngf: int = 8                   # generator width at the narrowest layer
    ndf: int = 64                  # discriminator width at the first layer
    nThreads: int = 4
    niter: int = 1
    lr: float = 2e-4
    beta1: float = 0.5             # Adam beta1 (reference uses torch/optim adam)
    beta2: float = 0.999
    eps: float = 1e-8
    ntrain: float = 10000          # examples per epoch; math.inf for full dataset
    name: str = "dcgan-sr-tpu"
    patchSize: int = 8
    overlap: int = 4
    manualSeed: Optional[int] = None

    # ---- structural knobs derived from each script's model/loss ----------
    nc: int = 1                    # channels (3 for rgb-full)
    loss: str = "bce"              # "bce" | "mse"
    # label scheme: constants or "per_image_mse" / "per_image_quarter_mse"
    real_label: float = 1.0
    fake_label: object = 0.0       # float or "per_image_mse"/"per_image_quarter_mse"
    g_label: float = 1.0
    # scale applied to the *reported* errD_real only (train-gray-2.lua:209
    # multiplies the printed loss by 100000 but backprops the unscaled one)
    report_scale_real: float = 1.0
    # optional pixel-reconstruction term on G: errG += weight * MSE(fake, real)
    # (no reference equivalent — the standard SR-GAN recipe; 0.0 = pure parity)
    pixel_loss_weight: float = 0.0
    # weight on G's adversarial gradient (1.0 = reference parity; 0.0 turns
    # the generator into a pure reconstruction CNN — with pixel_loss_weight
    # that is the PSNR-optimal regime; errG is still reported unweighted)
    gan_weight: float = 1.0
    # exponential moving average of G's params (no reference equivalent —
    # the standard fix for GAN epoch-to-epoch oscillation, measured >3 dB on
    # the textured protocol, PARITY.md). 0.0 = off (state carries no EMA
    # branch, exact parity); 0<d<1 maintains ema = d*ema + (1-d)*params each
    # step, evaluated via state.g_ema_params
    g_ema: float = 0.0
    # data value range: "pm1" = [-1,1] (folder loader hflip/normalize path),
    # "01" = [0,1] (direct image.load path)
    data_range: str = "01"
    patch_based: bool = False      # patch variants train on patchSize tiles
    images_per_step: Optional[int] = None  # patch-batch: images per step
    # discriminator family: "dcgan64" (5-layer stride-2) | "patch8" (3x3 valid)
    disc: str = "dcgan64"

    # ---- TPU execution knobs (no reference equivalent) -------------------
    compute_dtype: str = "float32"   # "float32" | "bfloat16"
    data_axis: str = "data"          # mesh axis name for data parallelism
    use_pallas: bool = False         # fused Pallas kernels for hot ops
    fast_ops: bool = False           # sub-pixel/s2d conv rewrites (ops/fast.py)
    # device_preprocess: the train step receives RAW [0,1] images (RGB for
    # nc=1 variants) and performs grayscale-convert + normalize + degrade on
    # device in one fused pass — the donkey hook's post-decode work moved
    # on-chip (north star; donkey_folder.lua:52-70)
    device_preprocess: bool = False
    # device_augment: the train step receives (canvas, tops, lefts, flips)
    # batches — raw loadSize canvases plus host-drawn trainHook crop offsets
    # and flip coins (the reference's single uniform draw over the full
    # aspect-resized image; data/folder.py sample_canvas) — and runs the
    # crop + hflip pixel work ON DEVICE (image/ops.py crop_hflip_at) before
    # the fused preprocess; the scalar offsets shard with the batch, so
    # scan/DP signatures are unchanged
    device_augment: bool = False
    # compact_params: store master weights (and Adam moments) as 2-D
    # (dim0, rest) matrices so the optimizer's elementwise passes run on
    # exactly-tiled tensors instead of ~64x-padded 4-D conv layouts
    # (ops/compact.py; the torch getParameters analogue, train.lua:202-203)
    compact_params: bool = False

    # ------------------------------------------------------------------
    @property
    def patch_number(self) -> int:
        """Patches per image: (fineSize/patchSize)^2 (train-gray-patch-batch.lua:21)."""
        n = self.fineSize // self.patchSize
        return n * n

    @property
    def step_batch(self) -> int:
        """Total samples per train step (patch variants expand images into patches)."""
        if self.patch_based:
            imgs = self.images_per_step if self.images_per_step else 1
            return imgs * self.patch_number
        return self.batchSize

    @property
    def train_size(self) -> int:
        """HR side length the generator maps to (patchSize for patch variants)."""
        return self.patchSize if self.patch_based else self.fineSize

    @property
    def images_consumed_per_step(self) -> int:
        """IMAGES drawn from the dataset per train step. Patch variants
        expand each image into patch_number tiles, so batchSize counts TILES
        there and images_per_step (default 1) counts the images."""
        return (self.images_per_step or 1) if self.patch_based else self.batchSize

    @property
    def test_file_set_start(self) -> int:
        """Held-out eval slice base, in file_set units of batchSize images
        (file_num = file_set * batchSize + k, e.g. overlap:247). Keyed on the
        VARIANT (not any overridable knob): the patch-BATCH protocol starts
        at file_set 10000 = images 200,001+ at its batchSize 20
        (train-gray-patch-batch.lua:489); every other variant at 2000 —
        images 200,001+ at batch 100 (train-gray-3.lua:449) and 128,001+ at
        gray-patch's batch 64 (train-gray-patch.lua:453)."""
        return 10000 if self.variant in ("gray-patch-batch",
                                         "gray-patch-batch-overlap") else 2000

    @property
    def overlap_patch_line(self) -> int:
        """Overlapping patches per row at stride=overlap
        ((fineSize - overlap) / (patchSize - overlap), overlap:387)."""
        return (self.fineSize - self.overlap) // (self.patchSize - self.overlap)


def _base(**kw) -> Config:
    return Config(**kw)


# The seven reference entry scripts, as named configs.
VARIANTS = {
    # train.lua: RGB full-image SR, error-regression D (real->0,
    # fake->per-image quarter-MSE, G->0), MSE criterion, threaded folder loader.
    "rgb-full": _base(
        variant="rgb-full", dataset="folder", nc=3, ngf=12, ndf=64,
        batchSize=100, ntrain=math.inf, loss="mse",
        real_label=0.0, fake_label="per_image_quarter_mse", g_label=0.0,
        data_range="pm1", disc="dcgan64", name="dcgan-sr-test-1",
    ),
    # train-gray.lua: grayscale (rgb2gray .21/.72/.07) full-image, no-BN G,
    # Tanh head, MSE, real->0.001, fake->per-image MSE, G->0.
    "gray": _base(
        variant="gray", dataset="folder", nc=1, ngf=16, ndf=64,
        batchSize=100, ntrain=math.inf, loss="mse",
        real_label=0.001, fake_label="per_image_mse", g_label=0.0,
        data_range="pm1", disc="dcgan64", name="dcgan-sr-test-1",
    ),
    # train-gray-2.lua: direct indexed loader, 3x nearest-upsample G, Sigmoid,
    # MSE, real->0 (reported x100000), fake->per-image MSE, G->0.001.
    "gray-2": _base(
        variant="gray-2", dataset="indexed", nc=1, ngf=64, ndf=64,
        batchSize=100, ntrain=10000, loss="mse",
        real_label=0.0, fake_label="per_image_mse", g_label=0.001,
        report_scale_real=100000.0, data_range="01", disc="dcgan64",
        name="dcgan-sr-test-1",
    ),
    # train-gray-3.lua: canonical GAN labels (1/0/1) with BCE; full eval harness.
    "gray-3": _base(
        variant="gray-3", dataset="indexed", nc=1, ngf=8, ndf=64,
        batchSize=100, ntrain=10000, loss="bce",
        real_label=1.0, fake_label=0.0, g_label=1.0,
        data_range="01", disc="dcgan64",
    ),
    # train-gray-patch.lua: one image -> 64 8x8 patches per step; patch D.
    "gray-patch": _base(
        variant="gray-patch", dataset="indexed", nc=1, ngf=16, ndf=64,
        batchSize=64, ntrain=10000, loss="bce",
        real_label=1.0, fake_label=0.0, g_label=1.0,
        data_range="01", disc="patch8", patch_based=True, images_per_step=1,
    ),
    # train-gray-patch-batch.lua: 20 images x 64 patches = 1280-patch batches;
    # all-conv G (no nearest-upsample prefix).
    "gray-patch-batch": _base(
        variant="gray-patch-batch", dataset="indexed", nc=1, ngf=16, ndf=64,
        batchSize=20, ntrain=10000, loss="bce",
        real_label=1.0, fake_label=0.0, g_label=1.0,
        data_range="01", disc="patch8", patch_based=True, images_per_step=20,
    ),
    # train-gray-patch-batch-overlap.lua: same training as patch-batch (with the
    # upsample-prefix G of gray-patch); inference adds overlap extraction and
    # minimum-error-boundary seam stitching.
    "gray-patch-batch-overlap": _base(
        variant="gray-patch-batch-overlap", dataset="indexed", nc=1, ngf=16,
        ndf=64, batchSize=20, ntrain=10000, loss="bce",
        real_label=1.0, fake_label=0.0, g_label=1.0,
        data_range="01", disc="patch8", patch_based=True, images_per_step=20,
        overlap=4,
    ),
}


@dataclasses.dataclass(frozen=True)
class SRResNetConfig:
    """SRGAN's generator (SRResNet; Ledig et al., 2017,
    arXiv:1609.04802, Fig. 4), a model the port runs beyond the seven
    reference variants.

    The seven variants' `Config` stays field for field the JAX package's
    (tests/test_torch_config.py), so this model carries its sizes here, in
    a table of its own (`MODELS`); `variant` is its name, as
    `Config.variant` is a variant's.  The layers (models/specs.py
    srresnet_spec): a k9 head conv and PReLU, `blocks` residual blocks
    (conv, BN, PReLU, conv, BN, sum) of `channels`, a conv and BN summed
    with the head's output (the long skip), `log2(scale)` upsampling blocks
    (conv to `up_channels`, PixelShuffle x2, PReLU) and a k9 tail conv with
    no activation.  Every conv has a bias; PReLU is channel-wise
    (ops/init.py init_prelu).  The input is in [0, 1] and the output in
    [-1, 1], as the paper's §3.2 scales them."""
    variant: str
    nc: int = 3
    channels: int = 64
    blocks: int = 16
    up_channels: int = 256
    scale: int = 4
    head_k: int = 9
    body_k: int = 3
    # what upscale.py reads of a model as of a variant's Config: whole
    # images, the output's range (`data_range`) and the input's
    patch_based: ClassVar[bool] = False
    data_range: ClassVar[str] = "pm1"
    lr_range: ClassVar[str] = "01"

    @property
    def up_blocks(self) -> int:
        """Upsampling blocks, each PixelShuffle x2."""
        n = self.scale.bit_length() - 1
        if self.scale != 1 << n or n < 1:
            raise ValueError(f"scale {self.scale} is not a power of two")
        return n


# Port-only models, by name; `resolve_config` looks a name up here and in
# VARIANTS.
MODELS = {
    "srgan-x4": SRResNetConfig(variant="srgan-x4"),
}


def resolve_config(name: str, env_override: bool = True):
    """A variant's Config (`get_config`) or a port-only model's, by name."""
    if name in MODELS:
        return MODELS[name]
    return get_config(name, env_override=env_override)


_ENV_TRUE = ("1", "true", "yes", "on")
_ENV_FALSE = ("0", "false", "no", "off", "")


def apply_env_overrides(cfg: Config, env=None) -> Config:
    """Reference parity: every opt key can be overridden by an env var of the
    same name, numbers parsed first (train.lua:26).

    Boolean fields (all TPU-side extensions — the reference opt table has
    none) parse true/false spellings strictly: with the reference's
    tonumber-or-string rule, ``use_pallas=false`` would store the truthy
    string 'false' and silently ENABLE the flag."""
    env = os.environ if env is None else env
    updates = {}
    for f in dataclasses.fields(Config):
        raw = env.get(f.name)
        if raw is None:
            continue
        if f.type == "bool":
            low = raw.strip().lower()
            if low in _ENV_TRUE:
                val = True
            elif low in _ENV_FALSE:
                val = False
            else:
                raise ValueError(
                    f"env override {f.name}={raw!r} is not a boolean "
                    f"(use one of {_ENV_TRUE + _ENV_FALSE})")
            updates[f.name] = val
            continue
        try:
            val = float(raw)
            # a non-finite value (ntrain=inf: the reference's math.huge)
            # stays a float; int() of it would raise OverflowError
            if (math.isfinite(val) and val == int(val)
                    and f.type in ("int", "Optional[int]")):
                val = int(val)
        except ValueError:
            val = raw
        updates[f.name] = val
    return dataclasses.replace(cfg, **updates)


def get_config(variant: str, env_override: bool = True, **overrides) -> Config:
    if variant not in VARIANTS:
        raise KeyError(f"unknown variant {variant!r}; have {sorted(VARIANTS)}")
    cfg = dataclasses.replace(VARIANTS[variant], **overrides)
    if env_override and cfg.variant != "gray-2":
        # train-gray-2.lua has no env-override line; all others do.
        cfg = apply_env_overrides(cfg)
    if cfg.device_augment and not cfg.device_preprocess:
        # device_augment crops raw [0,1] canvases on-chip; without the fused
        # preprocess the step would feed un-normalized data to a pm1 G (or
        # mis-shaped RGB to an nc=1 G). The implication is structural, so
        # enforce it here — AFTER env overrides, which can also set
        # device_augment — rather than per entry point.
        cfg = dataclasses.replace(cfg, device_preprocess=True)
    return cfg
