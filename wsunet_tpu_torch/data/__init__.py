from .transforms import center_crop

__all__ = ["center_crop"]
