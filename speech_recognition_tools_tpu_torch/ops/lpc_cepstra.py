"""Fused autocorrelation lags -> LPC -> cepstra (kernel K1).

Replaces the Pallas TPU kernel
speech_recognition_tools_tpu/ops/pallas_lpc.py::_lpc_cepstra_kernel
(launched by lpc_cepstra_pallas). The CUDA kernel is
csrc/lpc_cepstra.cu, built for sm_90a at first use (kernels.py).

What bounds it on an H100: a row reads order+2 floats and writes lim,
and needs about 2 order^2 + lim^2 flops (a dot and an update per Levinson
step, one FMA per cepstrum term) through two sequential recursions whose
every step ends in a reduction the next step needs. Operations bind at
the e2e shape (order 150, lim 100); bytes bind, narrowly, at the hybrid
shape (order 50, lim 50). In practice the per-step reductions bound it,
far above either. The design gives each row one warp: each step is a strided
per-lane partial sum plus one shuffle butterfly, with the lags, the
predictor (ping-pong copies) and the cepstra in shared memory and no block
barrier. See the source for the numbers at the main-path shape.

`lpc_cepstra` launches the kernel on a CUDA float32 tensor and runs the
plain version, `lpc_cepstra_reference`, on a CPU tensor. It never falls
back from the kernel to the plain version.
"""

import torch

from speech_recognition_tools_tpu_torch import kernels
from speech_recognition_tools_tpu_torch.ops.cepstrum import lpc_to_cepstrum
from speech_recognition_tools_tpu_torch.ops.levinson import lpc_from_autocorr


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
                unity_gain: bool = False) -> torch.Tensor:
    """(P, >= order+2) autocorrelation lags -> (P, lim) cepstra.

    CUDA float32 input with unit column stride launches the kernel on the
    current stream; CPU input runs `lpc_cepstra_reference`. Anything else
    raises.
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
    out = torch.empty((P, lim), dtype=torch.float32, device=r.device)
    if P == 0:
        return out
    lib = kernels.load()
    stream = torch.cuda.current_stream(r.device).cuda_stream
    rc = lib.lpc_cepstra_f32(
        r.data_ptr(), out.data_ptr(), P, r.stride(0), order, lim,
        int(bool(unity_gain)), stream,
    )
    if rc != 0:
        msg = lib.lpc_cepstra_error_string(rc).decode()
        raise RuntimeError(f"lpc_cepstra kernel launch failed: {msg} ({rc})")
    lpc_cepstra.launches += 1
    return out


lpc_cepstra.launches = 0
