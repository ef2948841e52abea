from .factory import create_model

__all__ = ["create_model"]
