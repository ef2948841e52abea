from .base_options import BaseOptions
from .test_options import TestOptions
from .train_options import TrainOptions

__all__ = ["BaseOptions", "TestOptions", "TrainOptions"]
