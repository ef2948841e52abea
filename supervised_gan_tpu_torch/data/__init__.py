from .loader import CreateDataLoader

__all__ = ["CreateDataLoader"]
