"""Fused autocorrelation lags -> LPC -> cepstra (kernel K1).

Replaces the Pallas TPU kernel
speech_recognition_tools_tpu/ops/pallas_lpc.py::_lpc_cepstra_kernel
(launched by lpc_cepstra_pallas). The CUDA kernel is
csrc/lpc_cepstra.cu, built for sm_90a at first use (kernels.py).

What bounds it on an H100: a row reads order+2 floats and writes lim,
and needs about 2 order^2 + 2 lim min(order, lim) flops through two
sequential recursions whose every step ends in a reduction the next step
needs. Operations bind at the e2e shape (order 150, lim 100) and the
reverb shape (order 150, lim 450); bytes bind, narrowly, at the hybrid
shape (order 50, lim 50). In practice each step's dependent chain and the
instructions it issues bound it, far above either. Tensor cores and TMA do
not apply: every row solves its own Toeplitz system, so no operand is
shared across rows, and the input is too small for bulk copies to matter.

Design: a group of L lanes per row (32/L rows per warp), each lane holding
a contiguous chunk of C entries of the Levinson shift registers (the TPU
kernel's a' = a + k u, u' = [k, (u + k a)[:-1]], s' = [r_i, s[:-1]]) in
registers, a step's reduction log2(L) shuffles of width L; then the
cepstrum over a window of the `order` latest d_m = m c_m in the same
registers, one FMA a term. `launch_plan` picks (L, C, rows per block)
from (order, lim) among the source's instantiations; see the source for
the details.

`lpc_cepstra` launches the kernel on a CUDA float32 tensor and runs the
plain version, `lpc_cepstra_reference`, on a CPU tensor. It never falls
back from the kernel to the plain version: a shape that no instantiation
covers raises.
"""

import math
import threading

import torch

from speech_recognition_tools_tpu_torch import kernels
from speech_recognition_tools_tpu_torch.ops.cepstrum import lpc_to_cepstrum
from speech_recognition_tools_tpu_torch.ops.levinson import lpc_from_autocorr

MAX_SMEM_PER_BLOCK = 232448  # bytes a block may use on sm_90
MAX_CHUNK_PER_LANE = 20  # the plan's longest register chunk before it widens the group
THREADS_PER_BLOCK = 128
_count_lock = threading.Lock()  # serving threads launch K1 concurrently


def smem_stride(order: int, lim: int) -> int:
    """Floats of shared memory per row (odd): the raw and the normalised
    lags, later the row's cepstra."""
    return max(2 * order + 2, lim) | 1


def launch_plan(order: int, lim: int, lanes: int | None = None,
                threads: int | None = None) -> tuple[int, int, int]:
    """(lanes L, chunk C, rows per block) for the kernel at (order, lim).

    L is the fewest lanes that keep a chunk within MAX_CHUNK_PER_LANE
    entries (or `lanes`, if given); C is the smallest instantiated chunk
    with L * C >= order; a block is THREADS_PER_BLOCK threads (or
    `threads`), halved while its row buffers do not fit in shared memory.
    Raises ValueError where no instantiation covers the shape.
    """
    if order < 1 or lim < 1:
        raise ValueError(f"order and lim must be >= 1 (got {order}, {lim})")
    all_lanes, chunks = kernels.instantiations()
    if lanes is None:
        lanes = next((n for n in all_lanes
                      if math.ceil(order / n) <= MAX_CHUNK_PER_LANE), all_lanes[-1])
    if lanes not in all_lanes:
        raise ValueError(f"no instantiation has {lanes} lanes per row ({all_lanes})")
    chunk = next((c for c in chunks if lanes * c >= order), None)
    if chunk is None:
        raise ValueError(f"order {order} exceeds the instantiations' reach of "
                         f"{lanes} x {chunks[-1]} with {lanes} lanes per row")
    threads = THREADS_PER_BLOCK if threads is None else threads
    row_bytes = 4 * smem_stride(order, lim)
    while threads > 32 and threads // lanes * row_bytes > MAX_SMEM_PER_BLOCK:
        threads //= 2
    if threads % 32 or not 32 <= threads <= 1024 or threads % lanes:
        raise ValueError(f"a block of {threads} threads is not whole warps of "
                         f"{lanes}-lane rows")
    rows = threads // lanes
    if rows * row_bytes > MAX_SMEM_PER_BLOCK:
        raise ValueError(f"(order {order}, lim {lim}) needs {rows * row_bytes} bytes of "
                         f"shared memory a block, more than {MAX_SMEM_PER_BLOCK}")
    return lanes, chunk, rows


def lpc_cepstra_reference(r: torch.Tensor, order: int, lim: int,
                          unity_gain: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K1, on any device:
    lpc_to_cepstrum(*lpc_from_autocorr(r, order), lim), with gg = 1 under
    `unity_gain` (modspec --set_unity_gain: cepstrum 0 becomes 0)."""
    xlpc, gg = lpc_from_autocorr(r, order)
    if unity_gain:
        gg = torch.ones_like(gg)
    return lpc_to_cepstrum(xlpc, gg, lim)


def lpc_cepstra(r: torch.Tensor, order: int, lim: int,
                unity_gain: bool = False,
                plan: tuple[int, int, int] | None = None) -> torch.Tensor:
    """(P, >= order+2) autocorrelation lags -> (P, lim) cepstra.

    CUDA float32 input with unit column stride launches the kernel on the
    current stream with `plan` (lanes, chunk, rows per block; default
    `launch_plan(order, lim)`); CPU input runs `lpc_cepstra_reference`.
    Anything else raises.
    """
    if r.ndim != 2 or r.shape[1] < order + 2:
        raise ValueError(f"expected (P, >= {order + 2}) lags, got {tuple(r.shape)}")
    if order < 1 or lim < 1:
        raise ValueError(f"order and lim must be >= 1 (got {order}, {lim})")
    if r.device.type == "cpu":
        return lpc_cepstra_reference(r, order, lim, unity_gain)
    if r.device.type != "cuda":
        raise ValueError(f"lpc_cepstra runs on cuda or cpu tensors, not {r.device}")
    if r.dtype != torch.float32:
        raise TypeError(f"the lpc_cepstra kernel takes float32, not {r.dtype}")
    P = r.shape[0]
    if r.stride(1) != 1 or (P > 1 and r.stride(0) < r.shape[1]):
        raise ValueError("the lpc_cepstra kernel needs row-major lags "
                         f"(strides {r.stride()})")
    lanes, chunk, rows_per_block = launch_plan(order, lim) if plan is None else plan
    out = torch.empty((P, lim), dtype=torch.float32, device=r.device)
    if P == 0:
        return out
    lib = kernels.load("lpc_cepstra")
    stream = torch.cuda.current_stream(r.device).cuda_stream
    rc = lib.lpc_cepstra_f32(
        r.data_ptr(), out.data_ptr(), P, r.stride(0), order, lim,
        int(bool(unity_gain)), lanes, chunk, rows_per_block, stream,
    )
    if rc != 0:
        msg = lib.lpc_cepstra_error_string(rc).decode()
        raise RuntimeError(f"lpc_cepstra kernel launch failed: {msg} ({rc}) with "
                           f"plan {(lanes, chunk, rows_per_block)}")
    with _count_lock:
        lpc_cepstra.launches += 1
    return out


lpc_cepstra.launches = 0
