from .t7 import load_t7, save_t7, T7Object  # noqa: F401
from .torch_import import import_torch_generator  # noqa: F401
from .torch_export import export_torch_generator  # noqa: F401
