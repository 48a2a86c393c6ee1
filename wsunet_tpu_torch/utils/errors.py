"""User-facing error type (copy of ``wsunet_tpu/utils/errors.py``).

A problem with the caller's request (missing card, bad argument), not a
bug in the framework.  Subclasses RuntimeError, as in the JAX package.
"""


class UserError(RuntimeError):
    """A problem with the user's request (missing model, bad selection),
    not a bug in the framework."""
