"""Fused momentum-SGD update over a flat pool: the CUDA kernel
(``csrc/fused_update.cu``), its wrapper, and its plain PyTorch version.

Replaces the Pallas kernel ``repro/kernels/fused_update.py::fused_update``
(body ``_kernel``, math ``update_math``): the masked momentum-SGD step of
Algorithm 1 over a whole pool, with an optional per-element scale (LARS),
returning the new master pool and the new momentum. No trainer path calls
it; ``optim.update_pool`` does (the trainer's update is the fused
update + unpack of ``pool_unpack``).

Bound on an H100: bytes — 21 B an element (reads of master, grads and
momentum at 4 B and the mask at 1 B; writes of master and momentum at
4 B), 25 B with the scale. The kernel's design for that bound is in the
note at the top of the source.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, ref


def _lib():
    fn = build.library("fused_update").fused_update_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [ctypes.c_longlong, p, p, p, p, p, p, ctypes.c_float,
                       ctypes.c_float, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def launch(master: torch.Tensor, grads: torch.Tensor,
           momentum_buf: torch.Tensor, mask: torch.Tensor, *, lr,
           momentum: float, weight_decay: float,
           scale: Optional[torch.Tensor] = None,
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the update on the pool's CUDA device and current stream.
    ``lr`` is an f32 scalar (a float or a 0-dim tensor). Returns new
    (master, momentum) tensors."""
    device = master.device
    if device.type != "cuda":
        raise ValueError(f"the fused_update kernel runs on CUDA, got "
                         f"{device}")
    n = master.shape[0]
    for name, t, dt in (("master", master, torch.float32),
                        ("grads", grads, torch.float32),
                        ("momentum", momentum_buf, torch.float32),
                        ("mask", mask, torch.bool),
                        ("scale", scale, torch.float32)):
        if t is not None and (t.dim() != 1 or t.shape[0] != n
                              or t.dtype != dt or t.device != device
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous {dt}[{n}] on "
                             f"{device}, got {t.dtype}{list(t.shape)} on "
                             f"{t.device}")
    new_master = torch.empty_like(master)
    new_mom = torch.empty_like(momentum_buf)
    if n == 0:
        return new_master, new_mom
    lr_t = torch.as_tensor(lr, dtype=torch.float32).reshape(1)
    if lr_t.device != device:
        lr_t = build.to_device(lr_t, device)
    fn = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(n, master.data_ptr(), grads.data_ptr(),
                 momentum_buf.data_ptr(), mask.view(torch.uint8).data_ptr(),
                 scale.data_ptr() if scale is not None else None,
                 lr_t.data_ptr(), momentum, weight_decay,
                 new_master.data_ptr(), new_mom.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fused_update kernel launch failed: CUDA error "
                           f"{err}")
    return new_master, new_mom


def plain(master: torch.Tensor, grads: torch.Tensor,
          momentum_buf: torch.Tensor, mask: torch.Tensor, *, lr,
          momentum: float, weight_decay: float,
          scale: Optional[torch.Tensor] = None,
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in PyTorch ops, on any device."""
    return ref.fused_update(master, grads, momentum_buf, mask, lr=lr,
                            momentum=momentum, weight_decay=weight_decay,
                            scale=scale)
