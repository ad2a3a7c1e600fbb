"""Device resolution and the sm_90 check.

Counterpart of tpu_knn/utils/platform.py. The rule: a torch tensor runs on
the device it is on; any other input (NumPy, lists) is copied to the
``device`` argument of the public function that received it. Nothing here
picks the CPU because no card was found. The CUDA kernels are built for
``sm_90a`` only, so a CUDA tensor on a card of any other compute
capability raises instead of failing later at launch.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

#: Compute capability the kernels are compiled for (csrc/build.py).
REQUIRED_CAPABILITY = (9, 0)


@functools.lru_cache(maxsize=None)
def _capability(index: int) -> tuple[int, int]:
    return torch.cuda.get_device_capability(index)


def check_device(device) -> torch.device:
    """Return ``device`` as a torch.device after checking the port can run
    there: the CPU (plain torch versions of every kernel) or an sm_90
    CUDA card (the hand-written kernels)."""
    device = torch.device(device)
    if device.type == "cuda":
        index = (device.index if device.index is not None
                 else torch.cuda.current_device())
        cap = _capability(index)
        if cap != REQUIRED_CAPABILITY:
            raise RuntimeError(
                f"{device} has compute capability {cap[0]}.{cap[1]}; the "
                "tpu_knn_torch kernels are built for sm_90a (H100/H200) only")
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device} (cpu or cuda only)")
    return device


def launch_stream(device: torch.device) -> int:
    """The raw handle of ``device``'s current stream, for a kernel launch
    through the library's C entries. The CUDA runtime launches into the
    thread's current device, so a wrapper launches inside
    ``torch.cuda.device(operand.device)``; called anywhere else (an operand
    on another card than the current one) this raises instead of handing
    one card's stream to a launch on another."""
    current = torch.cuda.current_device()
    if device.index is not None and device.index != current:
        raise RuntimeError(f"kernel launch for an operand on {device} while cuda:{current} "
                           "is the current device")
    return torch.cuda.current_stream(device).cuda_stream


@contextlib.contextmanager
def full_f32_matmul():
    """Products in true f32 on the card (tpu_knn's Precision.HIGHEST):
    TF32 is switched off for the block and the caller's setting restored
    after, whatever it was."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def as_f32(x, device) -> torch.Tensor:
    """A contiguous float32 tensor: tensors stay on their own device,
    anything else is converted through NumPy and placed on ``device``."""
    if isinstance(x, torch.Tensor):
        t = x.to(torch.float32)
    else:
        a = np.asarray(x, np.float32)
        if not a.flags.writeable:   # torch tensors must own writable memory
            a = a.copy()
        t = torch.as_tensor(a, device=device)
    check_device(t.device)
    return t.contiguous()


def as_f32_pair(search, ref, device) -> tuple[torch.Tensor, torch.Tensor]:
    """as_f32 on (queries, points), which must end up on one device."""
    search = as_f32(search, device)
    ref = as_f32(ref, device)
    if search.device != ref.device:
        raise ValueError(
            f"queries on {search.device} but points on {ref.device}: "
            "pass both on one device")
    return search, ref
