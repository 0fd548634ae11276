"""Low-bit wire formats with error feedback (int8 / fp8-e4m3 transport),
in PyTorch.

Each gradient chunk is quantized to int8 or fp8-e4m3 with a per-chunk
scale, the 1-byte words go on the wire, and the per-rank quantization
error is carried in a pool-shaped f32 residual that is added back to the
next step's gradient (error feedback), so the quantizer's bias
telescopes away over steps.

The scales come from the chunk-L1 census (the pack's, or CSC's summed
norms), summed over the data-parallel group, so every rank derives the
same scales with no side channel:

* ``meanabs_c = census_sum_c / (num_shards * chunk_elems)``;
* grid step ``s_c = WIRE_MARGIN * num_shards * meanabs_c / qmax``, and a
  per-rank clip at ``±floor(qmax / num_shards)``: any partial sum of the
  ring over at most ``num_shards`` ranks stays inside ``qmax``, so the
  wire word never saturates in flight. For fp8-e4m3 this also keeps every
  cast inside ±448, where PyTorch builds differ (one saturates, one gives
  NaN; ``kernels.ring_reduce.fp8_saturates``).
* int8 words are integers and their sums stay on the grid, so the ring's
  requantization at every hop is exact: all the quantization error is the
  local step's, and the residual holds it. fp8's grid is not uniform, so
  each hop may round.

These are PyTorch ops, not a kernel: the JAX package computes them in
``jnp`` outside any Pallas kernel. The functions write into caller
buffers where a pool-sized temporary would otherwise be made
(``quantize_pool``'s ``out``, ``dequantize_segment``'s in-place
multiply), with the same per-element arithmetic as the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import ref

# Per-rank coverage in multiples of the chunk's mean |g|: values beyond
# WIRE_MARGIN * meanabs clip and flow into the residual.
WIRE_MARGIN = 16.0

# Scales never collapse to zero: an all-zero chunk quantizes to zeros
# against the floor instead of dividing by zero.
SCALE_FLOOR = 1e-30


class WireSpec(NamedTuple):
    """One low-bit wire format: storage dtype and quantization range."""

    name: str
    dtype: torch.dtype
    qmax: float          # largest representable |value| on the wire grid
    integer_grid: bool   # partial sums stay on the grid (int8) or not


_FORMATS = {
    "int8": WireSpec("int8", torch.int8, 127.0, True),
    "fp8_e4m3": WireSpec("fp8_e4m3", torch.float8_e4m3fn, 448.0, False),
}


def supported_formats() -> Tuple[str, ...]:
    """Names accepted by ``GradientFlowConfig.wire_format``."""
    return ("native",) + tuple(sorted(_FORMATS))


def resolve(wire_format: Optional[str]) -> Optional[WireSpec]:
    """A config string -> its WireSpec; ``None`` / ``'native'`` -> None
    (the wire-dtype cast of §2.5). An unknown format raises."""
    if wire_format in (None, "native"):
        return None
    if wire_format not in _FORMATS:
        raise ValueError(f"unknown wire_format {wire_format!r}; "
                         f"expected one of {supported_formats()}")
    return _FORMATS[wire_format]


def is_quantized(wire_format: Optional[str]) -> bool:
    return wire_format not in (None, "native")


def rank_clip(spec: WireSpec, num_shards: int) -> float:
    """Per-rank wire clip ``floor(qmax / num_shards)``: every ring partial
    sum over at most ``num_shards`` ranks fits in ``qmax``."""
    return float(max(1.0, spec.qmax // max(1, num_shards)))


def chunk_l1(pool: torch.Tensor, chunk_elems: int) -> torch.Tensor:
    """Per-chunk L1 census in f32, for callers that hold no census from
    the pack (the pool is padded to a chunk multiple)."""
    assert pool.shape[0] % chunk_elems == 0, (pool.shape, chunk_elems)
    return ref.chunk_l1norm(pool, chunk_elems)


def scales_from_census(census_sum: torch.Tensor, *, chunk_elems: int,
                       num_shards: int, spec: WireSpec) -> torch.Tensor:
    """Per-chunk grid step from the census summed over the group (the same
    on every rank: CSC's chunk norms, or the dense/lazy census sum)."""
    meanabs = census_sum.to(torch.float32) / (num_shards * chunk_elems)
    return torch.clamp_min(meanabs * (WIRE_MARGIN * num_shards / spec.qmax),
                           SCALE_FLOOR)


def _chunk_rows(start: int, end: int, chunk_elems: int
                ) -> Tuple[int, int, int]:
    """(first chunk, chunks covered, offset of ``start`` in its chunk)."""
    c0 = start // chunk_elems
    c1 = -(-end // chunk_elems)
    return c0, c1 - c0, start - c0 * chunk_elems


def segment_scales(scales: torch.Tensor, start: int, end: int,
                   chunk_elems: int) -> torch.Tensor:
    """Per-element scales of pool span [start, end). Spans need not be
    chunk-aligned (buckets close at tensor boundaries): the covered
    chunks' scales, each repeated over its chunk, cut to the span. No
    per-element index is built."""
    c0, n, lead = _chunk_rows(start, end, chunk_elems)
    rows = scales[c0:c0 + n, None].expand(n, chunk_elems).reshape(-1)
    return rows[lead:lead + end - start]


def quantize_pool(g: torch.Tensor, scales: torch.Tensor, *,
                  chunk_elems: int, spec: WireSpec, num_shards: int,
                  out: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize ``g`` (f32, chunk-padded) onto the wire grid. Returns
    ``(q, err)`` where ``err = g - dequantize(q)`` is the error-feedback
    residual contribution. int8 rounds half to even, then clips at the
    per-rank clip; fp8 clips in f32 and the cast rounds onto the e4m3
    grid (err comes from the actual wire values either way, so the
    feedback is exact for both).

    ``out`` (f32, ``g``'s size, not aliasing it) is the one pool-sized
    buffer the pass needs: it holds the scaled values, then receives
    ``err``, which is returned in it."""
    assert g.shape[0] % chunk_elems == 0, (g.shape, chunk_elems)
    clip = rank_clip(spec, num_shards)
    rows = g.view(-1, chunk_elems)
    s = scales[:, None]
    if out is None:
        out = torch.empty(g.shape, dtype=torch.float32, device=g.device)
    buf = torch.div(rows, s, out=out.view(-1, chunk_elems))
    if spec.integer_grid:
        buf.round_()
    buf.clamp_(-clip, clip)
    q = buf.to(spec.dtype)
    # err = g - q * s, the dequantized words built in the same buffer.
    buf.copy_(q).mul_(s)
    torch.sub(rows, buf, out=buf)
    return q.view(-1), out


def dequantize_pool(q: torch.Tensor, scales: torch.Tensor,
                    chunk_elems: int) -> torch.Tensor:
    """Wire words (or their f32 ring sums) back to gradient units."""
    vals = q.to(torch.float32).view(-1, chunk_elems) * scales[:, None]
    return vals.view(-1)


def dequantize_segment(seg: torch.Tensor, scales: torch.Tensor, start: int,
                       end: int, chunk_elems: int) -> torch.Tensor:
    """Per-bucket dequantization of ``seg``, the summed scaled-domain
    segment of pool span [start, end): each element times its chunk's
    scale. An f32 ``seg`` is scaled in place (and returned); another
    dtype is cast to a new f32 tensor first."""
    out = seg if seg.dtype == torch.float32 else seg.to(torch.float32)
    c0, n, lead = _chunk_rows(start, end, chunk_elems)
    size = end - start
    # The span as whole chunk rows: a partial head, full rows, a partial
    # tail, each multiplied by its chunk's scale.
    head = min(size, (chunk_elems - lead) % chunk_elems)
    if head:
        out[:head].mul_(scales[c0])
    full = (size - head) // chunk_elems
    c = c0 + (1 if head else 0)
    body = out[head:head + full * chunk_elems].view(full, chunk_elems)
    body.mul_(scales[c:c + full, None])
    tail = size - head - full * chunk_elems
    if tail:
        out[size - tail:].mul_(scales[c + full])
    return out


def wire_itemsize(wire_format: Optional[str], wire_dtype: str) -> int:
    """Bytes per pool element on the wire: 1 for the low-bit formats, the
    wire dtype's size for native transport."""
    spec = resolve(wire_format)
    if spec is None:
        return torch.empty((), dtype=getattr(torch, wire_dtype)
                           ).element_size()
    return spec.dtype.itemsize
