"""The plain reference of the benchmark: the two CURL models, their applies,
the training loss and the recipe's optimizer in plain torch and float32. It
imports nothing of the program and takes nothing the program made."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def fp32():
    """cuBLAS and cuDNN in full float32 (TF32 off) while the block runs."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved
