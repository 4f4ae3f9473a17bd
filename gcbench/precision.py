"""The configurations' precision: float32 with TF32 off for matmuls and
cuDNN convolutions, set for the program and the reference alike.  The
control of ``gcbench/control.py`` turns TF32 on for the reference in the
program's place, the precision just below."""

import torch


def float32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
