from .model import EncDecModel, Model, XLSTMModel, build_model, cross_entropy
from .transformer import ModelContext, init_caches

__all__ = ["EncDecModel", "Model", "ModelContext", "XLSTMModel", "build_model", "cross_entropy",
           "init_caches"]
