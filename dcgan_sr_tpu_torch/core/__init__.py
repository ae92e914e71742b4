from .config import Config, VARIANTS, get_config, apply_env_overrides  # noqa: F401
from .config import MODELS, SRResNetConfig, resolve_config  # noqa: F401
