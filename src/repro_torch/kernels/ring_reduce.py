"""Ring all-reduce: the CUDA kernel (``csrc/ring_reduce.cu``), its
workspaces and peer transport, its wrapper, its schedule (``plan``), and
its plain PyTorch version.

Replaces the Pallas kernel ``repro/kernels/ring_reduce.py::ring_allreduce``
(body ``_kernel``): the 2(N-1)-step reduce-scatter + all-gather over one
level's N ranks, segments in the wire dtype, each received segment added
in f32 to the unrounded input, the owned segment rounded through the wire
once (so every rank ends with the same bits), credit flow control over the
receive slots (two in the Pallas kernel, ``SLOTS`` here). The Pallas
kernel keeps an f32 accumulator of the whole buffer and streams ~512 KiB
tiles through VMEM with remote DMA; here each of the kernel's CTAs owns
one lane of ``LANE_ELEMS`` elements of every sub-tile and runs its own
ring with the same CTA of its neighbours, through peer-visible device
memory, in rounds of ``ROUND_TILES`` sub-tiles: each step of a round
receives the round's sub-tiles, adds, requantizes, writes out and sends on
in one pass with one handshake, so the f32 value never leaves registers
(the design note is at the top of the source).

Peers. A ``RingWorkspace`` holds one rank's slots and flags and the
pointers to its neighbours': ``in_process`` wires N workspaces allocated
on one device (N ranks of one process, each launched on its own stream);
``across`` maps the neighbours' workspaces through CUDA IPC handles
exchanged once over the level's process group (one rank per process).
Both run the same kernel, its flags at system scope. ``prepare(group, device)`` sets up
one per level group and device, and every ring over that group uses it:
a workspace's size does not depend on the message, its sequence words
carry over between launches, and a rank runs all its rings in launch order
on one stream (``ops.comm_stream``), the same order on every rank, so
consecutive rings of any buckets share the slots safely.

Bound on an H100: bytes (``bound_bytes``); the N ranks of an in-process
ring share one device memory, so the bound counts every rank's bytes.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build, ref

LANE_ELEMS = 2048          # elements of one CTA's lane of a sub-tile
SLOTS = 8                  # S: receive slots of a lane (the Pallas kernel: 2)
ROUND_TILES = 4            # G: sub-tiles of a lane per round; the schedule
                           # is deadlock-free when 2G <= S
CTAS_PER_SM = 4            # ring CTAs an SM must hold at once (256 threads;
                           # the launcher checks the kernel's occupancy)
DEFAULT_SMS = 132          # H100 SXM; the wrapper reads the card's count
TIMEOUT_S = 20.0           # a wait longer than this traps the kernel
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
               torch.float8_e4m3fn: 3}


def ring_segment_bounds(n_elems: int, n_ranks: int,
                        seg: Optional[int] = None,
                        ) -> Tuple[Tuple[int, int], ...]:
    """Rank r owns ``[r*seg, min((r+1)*seg, n_elems))`` with
    ``seg = ceil(n_elems / n_ranks)`` by default: equal segments, a
    ragged final one, and empty ones for ranks past the data."""
    assert n_ranks >= 1, n_ranks
    if seg is None:
        seg = -(-n_elems // n_ranks) if n_elems else 0
    return tuple((min(r * seg, n_elems), min((r + 1) * seg, n_elems))
                 for r in range(n_ranks))


def max_lanes(n_ranks: int, sms: int = DEFAULT_SMS) -> int:
    """CTAs per rank: at most floor(CTAS_PER_SM * SMs / N), so the CTAs of
    N ranks are resident on one card at once."""
    return max(1, CTAS_PER_SM * sms // max(n_ranks, 1))


def workspace_bytes(lanes: int) -> int:
    """Bytes of one rank's workspace, in the layout the kernel reads
    (``ring_allreduce_launch``): three 8-byte flag words per lane (full,
    credit, sequence), rounded up to 256 B, then SLOTS slots of
    LANE_ELEMS 4-byte elements per lane (room for every wire dtype)."""
    return -(-3 * lanes * 8 // 256) * 256 + SLOTS * lanes * LANE_ELEMS * 4


def _itemsize(dtype) -> int:
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return torch.empty((), dtype=dtype).element_size()


def plan(n_elems: int, n_ranks: int, wire_dtype,
         sms: int = DEFAULT_SMS) -> Dict:
    """The kernel's static schedule and footprint (pure arithmetic).

    The segment is ceil(n/N) padded up to whole sub-tiles of
    ``lanes * LANE_ELEMS`` elements, with as many lanes (CTAs) as the
    segment fills, at most ``max_lanes``. ``segment_bounds``,
    ``seg_elems``, ``padded_elems``, ``exchange_steps``,
    ``wire_bytes_per_step`` and ``total_wire_bytes`` are the JAX
    package's ``plan`` fields for a tile of ``tile_elems``. Where the JAX
    plan reports VMEM, this one reports the device memory the kernel
    uses, ``workspace_bytes`` (slots and flags of one rank; the kernel
    allocates nothing else), and the schedule's ``slots`` (S) and
    ``round_tiles`` (G): each lane runs its sub-tiles in ``rounds`` =
    ``ceil(tiles_per_segment / G)`` rounds."""
    wsize = _itemsize(wire_dtype)
    raw_seg = -(-n_elems // n_ranks) if (n_elems and n_ranks > 1) else \
        n_elems
    lanes = min(max_lanes(n_ranks, sms),
                max(1, -(-raw_seg // LANE_ELEMS)))
    tile = lanes * LANE_ELEMS
    seg = -(-raw_seg // tile) * tile if raw_seg else 0
    steps = 2 * (n_ranks - 1) if n_ranks > 1 else 0
    padded = seg * n_ranks if n_ranks > 1 else n_elems
    tiles = seg // tile if seg else 0
    return {
        "segment_bounds": ring_segment_bounds(n_elems, n_ranks,
                                              seg if n_ranks > 1 else None),
        "seg_elems": seg,
        "padded_elems": padded,
        "exchange_steps": steps,
        "tiles_per_segment": tiles,
        "tile_elems": tile,
        "lanes": lanes,
        "wire_bytes_per_step": seg * wsize if n_ranks > 1 else 0,
        "total_wire_bytes": steps * seg * wsize,
        "workspace_bytes": workspace_bytes(max_lanes(n_ranks, sms)),
        "slots": SLOTS,
        "round_tiles": ROUND_TILES,
        "rounds": -(-tiles // ROUND_TILES),
    }


def bound_bytes(n_elems: int, n_ranks: int, wire_dtype, src_dtype) -> int:
    """Device-memory bytes one rank's ring must move, each read and write
    counted once: read x and write the output (x's dtype), and on each of
    the 2(N-1) exchange steps write one segment into the neighbour's wire
    slots and read one out of its own (wire dtype). The f32 sums live in
    registers between a receive and the next send, so nothing else is
    counted. Counted on the unpadded ``ceil(n/N)`` segment."""
    if n_ranks < 2 or not n_elems:
        return 0
    w, x = _itemsize(wire_dtype), _itemsize(src_dtype)
    seg = -(-n_elems // n_ranks)
    return 2 * n_elems * x + 2 * (n_ranks - 1) * seg * 2 * w


# -- the library ---------------------------------------------------------------


def _lib():
    lib = build.library("ring_reduce")
    fn = lib.ring_allreduce_launch
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, ll, ll, i, i, i, i, i, i, i, i, i, p, p, p, i,
                       ll, i, p]
        fn.restype = i
        lib.ring_allreduce_occupancy.argtypes = [
            i, i, ctypes.POINTER(ctypes.c_int)]
        lib.ring_allreduce_occupancy.restype = i
        pp = ctypes.POINTER(ctypes.c_void_p)
        lib.ring_ipc_alloc.argtypes = [i, ll, pp]
        lib.ring_ipc_handle.argtypes = [p, p]
        lib.ring_ipc_open.argtypes = [i, p, pp]
        lib.ring_ipc_close.argtypes = [p]
        lib.ring_ipc_free.argtypes = [p]
        for f in (lib.ring_ipc_alloc, lib.ring_ipc_handle,
                  lib.ring_ipc_open, lib.ring_ipc_close, lib.ring_ipc_free,
                  lib.ring_ipc_handle_bytes):
            f.restype = i
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"ring_allreduce {what} failed: CUDA error {err}")


_FP8_SATURATES: Optional[bool] = None


def fp8_saturates() -> bool:
    """Whether this PyTorch's ``.to(torch.float8_e4m3fn)`` saturates at
    ±448 past the format's range (newer builds) or gives NaN (older
    builds); the kernel follows the same rule."""
    global _FP8_SATURATES
    if _FP8_SATURATES is None:
        probe = torch.tensor([470.0, 1000.0, -1e6]).to(
            torch.float8_e4m3fn).float()
        if torch.equal(probe, torch.tensor([448.0, 448.0, -448.0])):
            _FP8_SATURATES = True
        elif bool(torch.isnan(probe).all()):
            _FP8_SATURATES = False
        else:
            raise RuntimeError(f"unknown float8_e4m3fn overflow rule: "
                               f"{probe.tolist()}")
    return _FP8_SATURATES


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _launch_shape(n_elems: int, n_ranks: int, wire, sms: int):
    """(segment elements, lanes) of ``plan``, kept per message shape (a
    trainer launches the same few bucket shapes every step)."""
    p = plan(n_elems, n_ranks, wire, sms=sms)
    return p["seg_elems"], p["lanes"]


def _cuda_device(device) -> torch.device:
    """``device`` with its index ('cuda' -> 'cuda:<current>')."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"ring workspaces live on a CUDA device, got "
                         f"{device}")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


# -- workspaces ----------------------------------------------------------------


@dataclasses.dataclass
class RingWorkspace:
    """One rank's slots and flags on ``device`` and the device pointers
    to its neighbours' (``right`` receives what this rank sends, ``left``
    sends what it receives). ``keep`` holds what owns the memory."""

    device: torch.device
    n_ranks: int
    rank: int
    lanes: int
    mine: int
    right: int
    left: int
    keep: list = dataclasses.field(default_factory=list)
    opened: list = dataclasses.field(default_factory=list)
    allocated: int = 0
    group: object = None

    @staticmethod
    def in_process(n_ranks: int, device) -> List["RingWorkspace"]:
        """N workspaces on one device for N ranks of this process."""
        device = _cuda_device(device)
        lanes = max_lanes(n_ranks, _sms(device))
        bufs = [torch.zeros(workspace_bytes(lanes), dtype=torch.uint8,
                            device=device) for _ in range(n_ranks)]
        return [RingWorkspace(device=device, n_ranks=n_ranks, rank=r,
                              lanes=lanes, mine=bufs[r].data_ptr(),
                              right=bufs[(r + 1) % n_ranks].data_ptr(),
                              left=bufs[(r - 1) % n_ranks].data_ptr(),
                              keep=bufs)
                for r in range(n_ranks)]

    @staticmethod
    def across(lg, device) -> "RingWorkspace":
        """This rank's workspace for a ring over the level group ``lg``
        (``collectives.LevelGroup``, one rank per process): allocate it,
        exchange CUDA IPC handles once over the group, and map the two
        neighbours'. Every rank of the group must call this together."""
        import torch.distributed as dist
        device = _cuda_device(device)
        lib = _lib()
        n, me = lg.size, lg.index
        lanes = max_lanes(n, _sms(device))
        ptr = ctypes.c_void_p()
        _check(lib.ring_ipc_alloc(device.index, workspace_bytes(lanes),
                                  ctypes.byref(ptr)), "workspace alloc")
        handle = ctypes.create_string_buffer(lib.ring_ipc_handle_bytes())
        _check(lib.ring_ipc_handle(ptr, handle), "IPC handle")
        handles = [None] * n
        dist.all_gather_object(handles, bytes(handle.raw), group=lg.group)
        peers: Dict[int, int] = {}
        for r in ((me + 1) % n, (me - 1) % n):
            if r not in peers:
                peer = ctypes.c_void_p()
                _check(lib.ring_ipc_open(device.index, handles[r],
                                         ctypes.byref(peer)), "IPC open")
                peers[r] = peer.value
        return RingWorkspace(device=device, n_ranks=n, rank=me, lanes=lanes,
                             mine=ptr.value, right=peers[(me + 1) % n],
                             left=peers[(me - 1) % n],
                             opened=list(peers.values()),
                             allocated=ptr.value, group=lg.group)

    def close(self) -> None:
        """Unmap the neighbours' memory and free this rank's."""
        lib = _lib() if (self.opened or self.allocated) else None
        for p in self.opened:
            lib.ring_ipc_close(ctypes.c_void_p(p))
        if self.allocated:
            lib.ring_ipc_free(ctypes.c_void_p(self.allocated))
        self.opened, self.allocated, self.keep = [], 0, []


_WORKSPACES: Dict[Tuple, RingWorkspace] = {}


def prepare(lg, device) -> RingWorkspace:
    """Set up the cross-process workspace of the level group ``lg`` on
    ``device`` if it is not yet (collectively: every rank of the group
    calls this for the same groups in the same order)."""
    device = _cuda_device(device)
    key = (tuple(lg.ranks), device.index)
    ws = _WORKSPACES.get(key)
    if ws is None:
        ws = _WORKSPACES[key] = RingWorkspace.across(lg, device)
    return ws


def workspace(lg, device) -> RingWorkspace:
    """The workspace ``prepare`` set up for ``lg`` on ``device``."""
    device = _cuda_device(device)
    ws = _WORKSPACES.get((tuple(lg.ranks), device.index))
    if ws is None:
        raise RuntimeError(f"no ring workspace for the group of ranks "
                           f"{lg.ranks} on {device}: call "
                           f"kernels.ops.ring_prepare first (the Trainer "
                           f"does when it is built)")
    return ws


def release_workspaces() -> None:
    """Close every workspace ``prepare`` set up. Collective: every rank
    calls it while its groups still exist; it waits for this rank's rings
    and for the group's other ranks (a neighbour's last credit may still
    be landing in this rank's memory until then) before unmapping and
    freeing."""
    import torch.distributed as dist
    for ws in _WORKSPACES.values():
        torch.cuda.synchronize(ws.device)
    for ws in _WORKSPACES.values():
        dist.barrier(group=ws.group)
        ws.close()
    _WORKSPACES.clear()


# -- launch --------------------------------------------------------------------


def launch(x: torch.Tensor, ws: RingWorkspace,
           wire_dtype: Optional[torch.dtype] = None,
           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch one rank's ring on the current stream of x's device: x (n,)
    of f32/bf16/int8/fp8-e4m3; the result in x's dtype, written into
    ``out`` (may be ``x`` itself) or a new tensor. The other ranks of the
    ring must launch theirs concurrently (other streams or processes)."""
    device = x.device
    if device.type != "cuda" or device != ws.device:
        raise ValueError(f"the ring_allreduce kernel runs on the "
                         f"workspace's CUDA device {ws.device}, got x on "
                         f"{device}")
    wire = wire_dtype or x.dtype
    if x.dtype not in DTYPE_CODES or wire not in DTYPE_CODES:
        raise TypeError(f"ring_allreduce takes {list(DTYPE_CODES)}, got x "
                        f"{x.dtype}, wire {wire}")
    if x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"x must be contiguous 1-D, got shape "
                         f"{tuple(x.shape)}")
    if out is None:
        out = torch.empty_like(x)
    elif (out.shape != x.shape or out.dtype != x.dtype
          or out.device != device or not out.is_contiguous()):
        raise ValueError("out must be contiguous and match x")
    n = x.shape[0]
    if n == 0:
        return out
    seg, lanes = _launch_shape(n, ws.n_ranks, wire, _sms(device))
    assert lanes <= ws.lanes, (lanes, ws.lanes)
    fn = _lib().ring_allreduce_launch
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), n, seg,
                 ws.n_ranks, ws.rank, lanes, LANE_ELEMS, SLOTS,
                 ROUND_TILES, CTAS_PER_SM, DTYPE_CODES[x.dtype],
                 DTYPE_CODES[wire], ws.mine, ws.right, ws.left, ws.lanes,
                 int(TIMEOUT_S * 1e9), int(fp8_saturates()), stream)
    _check(err, "launch")
    return out


def occupancy(x_dtype: torch.dtype, wire_dtype: torch.dtype,
              device=None) -> int:
    """CTAs of the kernel for (x, wire) that one SM of ``device`` holds at
    once; ``launch`` refuses to run below ``CTAS_PER_SM``."""
    blocks = ctypes.c_int()
    with torch.cuda.device(_cuda_device(device or "cuda")):
        _check(_lib().ring_allreduce_occupancy(
            DTYPE_CODES[x_dtype], DTYPE_CODES[wire_dtype],
            ctypes.byref(blocks)), "occupancy query")
    return blocks.value


def launch_ranks(xs: Sequence[torch.Tensor],
                 workspaces: Sequence[RingWorkspace],
                 wire_dtype: Optional[torch.dtype] = None,
                 outs: Optional[Sequence[torch.Tensor]] = None,
                 streams: Optional[Sequence[torch.cuda.Stream]] = None,
                 ) -> List[torch.Tensor]:
    """The ring over N ranks of one process on one device: each rank's
    kernel on its own stream (they run at the same time), joined back
    into the current stream. ``workspaces`` from
    ``RingWorkspace.in_process``."""
    n = len(xs)
    assert len(workspaces) == n, (len(workspaces), n)
    device = xs[0].device
    cur = torch.cuda.current_stream(device)
    if streams is None:
        streams = [torch.cuda.Stream(device) for _ in range(n)]
    outs = list(outs) if outs is not None else [torch.empty_like(x)
                                                for x in xs]
    ready = cur.record_event()
    for r in range(n):
        streams[r].wait_event(ready)
    for r in range(n):
        with torch.cuda.stream(streams[r]):
            launch(xs[r], workspaces[r], wire_dtype, out=outs[r])
        xs[r].record_stream(streams[r])
        outs[r].record_stream(streams[r])
    for s in streams:
        cur.wait_stream(s)
    return outs


def plain(xs: Sequence[torch.Tensor],
          wire_dtype: Optional[torch.dtype] = None,
          seg_elems: Optional[int] = None) -> List[torch.Tensor]:
    """The kernel's function in PyTorch ops over N ranks' tensors, on any
    device (``seg_elems``: the kernel's padded segment, from ``plan``)."""
    return ref.ring_allreduce_ranks(xs, wire_dtype, seg_elems)
