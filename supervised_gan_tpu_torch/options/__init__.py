from .base_options import BaseOptions
from .test_options import TestOptions

__all__ = ["BaseOptions", "TestOptions"]
