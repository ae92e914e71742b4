"""The port's config and specs (dcgan_sr_tpu_torch.core / models.specs)
equal the JAX package's for every variant and every env-override rule."""

import dataclasses

import pytest

from dcgan_sr_tpu import core as J
from dcgan_sr_tpu.models import specs as JS
from dcgan_sr_tpu_torch import core as T
from dcgan_sr_tpu_torch.models import specs as TS

import torch_threads  # noqa: F401

VARIANTS = sorted(J.VARIANTS)


def test_variant_tables_match():
    assert sorted(T.VARIANTS) == VARIANTS
    assert [f.name for f in dataclasses.fields(T.Config)] == \
        [f.name for f in dataclasses.fields(J.Config)]


@pytest.mark.parametrize("variant", VARIANTS)
def test_config_and_specs_match(variant):
    jc = J.get_config(variant, env_override=False)
    tc = T.get_config(variant, env_override=False)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    for prop in ("patch_number", "step_batch", "train_size",
                 "images_consumed_per_step", "test_file_set_start",
                 "overlap_patch_line"):
        assert getattr(tc, prop) == getattr(jc, prop), prop
    assert TS.generator_spec(tc) == JS.generator_spec(jc)
    assert TS.discriminator_spec(tc) == JS.discriminator_spec(jc)


# the env-override cases of tests/test_config.py, each through both packages
ENV_CASES = [
    {"lr": "0.001", "name": "run-x", "batchSize": "64"},
    {"HOME": "/home/user", "PATH": "x"},
    {"ngf": "4", "ndf": "8", "fineSize": "32"},
    {"ntrain": "5000", "overlap": "2", "manualSeed": "3"},
    *({"use_pallas": s} for s in ("0", "false", "FALSE", "no", "off", "")),
    *({"use_pallas": s} for s in ("1", "true", "True", "yes", "on")),
]


@pytest.mark.parametrize("env", ENV_CASES)
def test_env_overrides_match(env):
    for base in ({}, {"use_pallas": True}):
        out_t = T.apply_env_overrides(T.Config(**base), env=env)
        out_j = J.apply_env_overrides(J.Config(**base), env=env)
        assert dataclasses.asdict(out_t) == dataclasses.asdict(out_j)
        for f in dataclasses.fields(T.Config):
            assert type(getattr(out_t, f.name)) is type(getattr(out_j, f.name))


def test_env_override_bad_bool_raises_in_both():
    for mod in (T, J):
        with pytest.raises(ValueError):
            mod.apply_env_overrides(mod.Config(),
                                    env={"device_preprocess": "maybe"})


def test_gray2_ignores_env_and_augment_implies_preprocess(monkeypatch):
    monkeypatch.setenv("batchSize", "7")
    monkeypatch.setenv("device_augment", "1")
    monkeypatch.setenv("device_preprocess", "0")
    for v in VARIANTS:
        assert dataclasses.asdict(T.get_config(v)) == \
            dataclasses.asdict(J.get_config(v))
    assert T.get_config("gray-2").batchSize == 100
    assert T.get_config("gray-3").batchSize == 7
    assert T.get_config("rgb-full").device_preprocess


def test_kwarg_overrides_match():
    kw = dict(ngf=32, batchSize=10)
    assert dataclasses.asdict(T.get_config("gray-3", env_override=False, **kw)) \
        == dataclasses.asdict(J.get_config("gray-3", env_override=False, **kw))
    with pytest.raises(TypeError):
        T.get_config("gray-3", env_override=False, nonexistent_field=1)
    with pytest.raises(KeyError):
        T.get_config("no-such-variant")


@pytest.mark.parametrize("raw", ["inf", "Infinity", "-inf"])
def test_non_finite_ntrain_override_stays_a_float_in_the_port(monkeypatch,
                                                              raw):
    """The port only: ntrain=inf by env gives what the rgb-full and gray
    defaults hold (math.inf) where the JAX package's copy raises
    OverflowError from int(inf)."""
    import math
    monkeypatch.setenv("ntrain", raw)
    cfg = T.get_config("gray-3")
    assert cfg.ntrain == float(raw) and not math.isfinite(cfg.ntrain)
    assert isinstance(cfg.ntrain, float)
    if raw == "inf":
        assert cfg.ntrain == math.inf == \
            T.get_config("rgb-full", env_override=False).ntrain
        # nan too is kept as the float it is
        out = T.apply_env_overrides(T.Config(), env={"ntrain": "nan"})
        assert math.isnan(out.ntrain)
