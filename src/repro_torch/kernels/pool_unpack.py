"""Pool unpack + momentum-SGD update: the CUDA kernel
(``csrc/pool_unpack.cu``), its wrapper, and its plain PyTorch version.

Replaces the Pallas kernel ``repro/kernels/pool_unpack.py::
pool_unpack_update`` (body ``_kernel``; the math is
``repro/kernels/fused_update.py::update_math``, carried here as
``update_math``): the masked momentum-SGD step of Algorithm 1 over one
pool span, with an optional per-element ``scale`` or per-tensor
``ratios``, writing the new momentum and scattering the new master values
straight into the per-tensor leaves. An optional device ``bool[1]``
``ok`` (the numeric guard's verdict) predicates the whole launch: when it
is false nothing is written.

In place: the port writes the new momentum into ``out_momentum`` and the
new master values into ``out_leaves``, which may be the momentum buffer
and the parameter tensors themselves. That is safe because the master
span was packed from the parameters before the update, and it saves the
pool-sized output buffer the JAX kernel allocates. With ``ok`` the
outputs must be the live parameters and momentum (``check_ok``): a
skipped launch into fresh tensors would hand back uninitialised memory.
The JAX package skips with a ``where`` over the whole computed update
(``repro/core/engine.py::_guarded_pool``); here that select would be one
more pool-sized pass of parameters and momentum, the predicate costs a
byte a CTA.

Bound on an H100: bytes — 21 B an element (reads of master, grads and
momentum at 4 B and the mask at 1 B; writes of momentum and the leaf at
4 B), 3.35 TB/s on the SXM card. The kernel's design for that bound is in
the note at the top of the source.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.pool_pack import check_segments, segment_table

update_math = ref.update_math


def _lib():
    fn = build.library("pool_unpack").pool_unpack_update_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                       p, p, p, p, p, p, ctypes.c_float, ctypes.c_float,
                       p, p, ctypes.c_int, p, p]
        fn.restype = ctypes.c_int
    return fn


def _outputs(master, momentum_buf, sizes, out_leaves, out_momentum):
    if out_leaves is None:
        out_leaves = [torch.empty((s,), dtype=master.dtype,
                                  device=master.device) for s in sizes]
    if out_momentum is None:
        out_momentum = torch.empty_like(momentum_buf)
    return list(out_leaves), out_momentum


def check_ok(ok: Optional[torch.Tensor], momentum_buf: torch.Tensor,
             out_leaves, out_momentum) -> None:
    """Refuse a guard predicate that could leave garbage: ``ok`` must be
    one bool on the update's device, and the outputs must be given, the
    momentum written in place (``out_momentum`` is ``momentum_buf``)."""
    if ok is None:
        return
    if (ok.dtype != torch.bool or ok.numel() != 1
            or ok.device != momentum_buf.device):
        raise ValueError(f"ok must be one bool on {momentum_buf.device}, "
                         f"got {ok.dtype}{list(ok.shape)} on {ok.device}")
    if (out_leaves is None or out_momentum is None
            or out_momentum.data_ptr() != momentum_buf.data_ptr()
            or out_momentum.shape != momentum_buf.shape):
        raise ValueError("ok needs the outputs to be the live parameters "
                         "and momentum: pass out_leaves and "
                         "out_momentum=momentum_buf")


def launch(master: torch.Tensor, grads: torch.Tensor,
           momentum_buf: torch.Tensor, mask: torch.Tensor,
           offsets: Sequence[int], sizes: Sequence[int], *, lr,
           momentum: float, weight_decay: float,
           scale: Optional[torch.Tensor] = None,
           ratios: Optional[torch.Tensor] = None,
           out_leaves: Optional[Sequence[torch.Tensor]] = None,
           out_momentum: Optional[torch.Tensor] = None,
           ok: Optional[torch.Tensor] = None,
           ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Launch the update kernel on the span's CUDA device and current
    stream. ``lr`` is an f32 scalar (a float or a 0-dim tensor). Returns
    (leaves in segment-table order, new momentum): ``out_leaves`` /
    ``out_momentum`` when given (``out_momentum`` may be
    ``momentum_buf``), else new tensors. ``ok``: see ``check_ok``."""
    device = master.device
    if device.type != "cuda":
        raise ValueError(f"the pool_unpack_update kernel runs on CUDA, got "
                         f"{device}")
    n = master.shape[0]
    if scale is not None and ratios is not None:
        raise ValueError("pass scale OR ratios, not both")
    for name, t, dt in (("master", master, torch.float32),
                        ("grads", grads, torch.float32),
                        ("momentum", momentum_buf, torch.float32),
                        ("mask", mask, torch.bool),
                        ("scale", scale, torch.float32)):
        if t is not None and (t.shape != (n,) or t.dtype != dt
                              or t.device != device
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous {dt}[{n}] on "
                             f"{device}, got {t.dtype}{list(t.shape)} on "
                             f"{t.device}")
    if ratios is not None and (ratios.dtype != torch.float32
                               or ratios.device != device
                               or ratios.shape[0] not in (len(sizes),
                                                          len(sizes) + 1)):
        raise ValueError("ratios must be f32[num_tensors(+1)] on the device")
    check_ok(ok, momentum_buf, out_leaves, out_momentum)
    out_leaves, out_momentum = _outputs(master, momentum_buf, sizes,
                                        out_leaves, out_momentum)
    if any(x.dtype != torch.float32 for x in out_leaves):
        raise TypeError("the pool_unpack_update kernel writes f32 leaves")
    check_segments(out_leaves, offsets, sizes, n, device)
    if (out_momentum.shape != (n,) or out_momentum.dtype != torch.float32
            or out_momentum.device != device
            or not out_momentum.is_contiguous()):
        raise ValueError("out_momentum must be contiguous f32[n] on the "
                         "device")
    lr_t = torch.as_tensor(lr, dtype=torch.float32).reshape(1)
    if lr_t.device != device:
        lr_t = build.to_device(lr_t, device)
    ratios_c = ratios.contiguous() if ratios is not None else None
    table = segment_table(out_leaves, offsets, sizes, device)
    covered = offsets[-1] + sizes[-1] if sizes else 0
    fn = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(table.data_ptr(), len(sizes), covered, n,
                 master.data_ptr(), grads.data_ptr(), momentum_buf.data_ptr(),
                 out_momentum.data_ptr(), mask.view(torch.uint8).data_ptr(),
                 lr_t.data_ptr(), momentum, weight_decay,
                 scale.data_ptr() if scale is not None else None,
                 ratios_c.data_ptr() if ratios_c is not None else None,
                 ratios_c.shape[0] if ratios_c is not None else 0,
                 ok.data_ptr() if ok is not None else None, stream)
    if err != 0:
        raise RuntimeError(f"pool_unpack_update kernel launch failed: CUDA "
                           f"error {err}")
    return out_leaves, out_momentum


def plain(master: torch.Tensor, grads: torch.Tensor,
          momentum_buf: torch.Tensor, mask: torch.Tensor,
          offsets: Sequence[int], sizes: Sequence[int], *, lr,
          momentum: float, weight_decay: float,
          scale: Optional[torch.Tensor] = None,
          ratios: Optional[torch.Tensor] = None,
          out_leaves: Optional[Sequence[torch.Tensor]] = None,
          out_momentum: Optional[torch.Tensor] = None,
          ok: Optional[torch.Tensor] = None,
          ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The kernel's function in PyTorch ops, on any device, with the same
    outputs as ``launch`` (leaves copied into ``out_leaves`` and the
    momentum into ``out_momentum`` when given; a leaf of another dtype is
    cast, as the JAX optimizer casts leaves to their declared dtype).
    With ``ok`` the outputs take the new values only where it holds
    (``ref.commit_where``)."""
    check_ok(ok, momentum_buf, out_leaves, out_momentum)
    leaves, new_mom = ref.pool_unpack_update(
        master, grads, momentum_buf, mask, offsets, sizes, lr=lr,
        momentum=momentum, weight_decay=weight_decay, scale=scale,
        ratios=ratios)
    if ok is not None:
        ref.commit_where(ok, list(leaves) + [new_mom],
                         list(out_leaves) + [out_momentum])
        return list(out_leaves), out_momentum
    if out_leaves is not None:
        for dst, src in zip(out_leaves, leaves):
            dst.copy_(src)
        leaves = list(out_leaves)
    if out_momentum is not None:
        out_momentum.copy_(new_mom)
        new_mom = out_momentum
    return leaves, new_mom
