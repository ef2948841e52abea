from .images import tensor2im, save_image, mkdirs

__all__ = ["tensor2im", "save_image", "mkdirs"]
