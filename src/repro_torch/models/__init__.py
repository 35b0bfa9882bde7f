from .model import Model, build_model, cross_entropy
from .transformer import init_caches

__all__ = ["Model", "build_model", "cross_entropy", "init_caches"]
