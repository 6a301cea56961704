from .registry import Model, get_model

__all__ = ["Model", "get_model"]
