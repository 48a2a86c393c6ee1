"""Plain PyTorch references of the benchmark's configurations: no kernel,
cache or batching of the program, and nothing imported from it."""

import contextlib

import torch


@contextlib.contextmanager
def precision(tf32: bool = False):
    """Run the references' float32 convolutions and matmuls in full
    float32 (the configurations' precision), or with ``tf32`` in TF32 (the
    checks' control); the switches are restored after."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
