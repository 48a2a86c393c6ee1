from .errors import UserError

__all__ = ["UserError"]
