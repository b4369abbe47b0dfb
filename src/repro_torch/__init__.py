"""MultiScope in PyTorch and CUDA: the port of the JAX package ``repro``.

The port runs the pipeline's main path (one clip through
``core.executor.ClipExecutor``: decode -> proxy -> detect -> track) on an
NVIDIA GPU, with TRACK on the host or on the device, the per-frame engine
and the unfused proxy path, and the serving path of every language-model
family (``serve.ServeEngine`` over ``models``: ragged prefill, then
decode) and their training step (``Model.loss``, ``train.TrainStep``).
Its kernels, ``kernels.proxy_plan``,
``kernels.proxy_score``, ``kernels.window_gather`` (two),
``kernels.assign``, ``kernels.track_step``, ``kernels.flash_attention``
(and its backward), ``kernels.decode_attention`` and
``kernels.ssd_scan``, are hand-written CUDA; everything else is
ordinary PyTorch or host numpy.  It imports nothing of JAX and nothing
of ``repro``; the tests hold it against ``repro`` on the CPU.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``); ``resolve_device`` raises when the card is asked for
and there is none, so nothing carries on quietly on the CPU.

Importing this package pins PyTorch's float32 numerics: TF32 off for
both matmul and cuDNN (cuDNN convolutions default to TF32, which keeps
about three decimal digits), and deterministic cuDNN algorithm choice.
"""
from __future__ import annotations

from typing import Union

import torch

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.benchmark = False
torch.backends.cudnn.deterministic = True

DEFAULT_DEVICE = "cuda"

Device = Union[str, torch.device]


def resolve_device(device: Device = DEFAULT_DEVICE) -> torch.device:
    """The torch device an entry point runs on.  Only "cpu" and "cuda"
    devices are accepted; a CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} asked for, but no CUDA device is "
                "available (pass device='cpu' to run on the CPU)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r}: "
                         "expected 'cpu' or 'cuda'")
    return dev
