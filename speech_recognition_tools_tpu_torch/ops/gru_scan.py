"""The time loop of one masked GRU layer (kernel K3).

Replaces no Pallas kernel: the JAX package runs the recurrence as a
lax.scan (speech_recognition_tools_tpu/models/recurrent.py), which XLA
compiles into one loop on the TPU. The CUDA kernel is csrc/gru_scan.cu,
built for sm_90a at first use (kernels.py): one launch carries a layer's
recurrence over all T frames forward, one its gradient backward, where
the plain version steps the frames in Python at ~15 launches a frame and
~30 more in autograd.

What bounds it on an H100: a frame's recurrent product, 2 B 3H H float32
operations (TF32 is off), and in practice the chain from frame to frame:
a frame's latency (product, gate algebra, exchange of h) is its time.
Design: a thread block cluster of up to 16 blocks takes a group of batch
rows (6 at H <= 512, 8 above), each block the three gate rows of its
share of the hidden units, its slice of W_hh in shared memory for the
whole launch (H <= 512) or read from L2 every frame (H <= 1024); the new
h goes to the cluster's blocks through distributed shared memory, counted
on each receiver's mbarrier. See the source for the details.

`gru_scan` launches the kernel for CUDA float32 input and runs the plain
version, `gru_scan_reference`, for CPU input. It never falls back from the
kernel to the plain version: CUDA input the kernel does not take raises.
The gradient is a torch.autograd.Function whose backward is the kernel's
companion; dW_hh and d b_hn are plain matrix products of its output.

What the card no longer takes (the plain loop took it; no configuration
or caller of the port needs it): hidden sizes above 1024, any dtype but
float32 (bf16, float16, float64), a non-contiguous xi or bias_hn, and a
second derivative (the backward is once_differentiable). Each raises.
"""

import dataclasses
import math
import threading

import torch
import torch.nn.functional as F

from speech_recognition_tools_tpu_torch import kernels

MAX_CLUSTER = 16  # blocks a cluster (non-portable on the H100)
_count_lock = threading.Lock()  # serving threads may run models concurrently


def length_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) -> (B, T) boolean validity mask."""
    return torch.arange(max_len, device=lengths.device)[None, :] < lengths[:, None]


def gru_cell(xi: torch.Tensor, h: torch.Tensor, weight_hh: torch.Tensor,
             bias_hn: torch.Tensor) -> torch.Tensor:
    """One step of the gate algebra: the input projection xi = W_i x + b_i
    (N, 3H) and the carry h (N, H) -> the new carry (N, H)."""
    H = h.shape[-1]
    hh = h @ weight_hh.T
    x_r, x_z, x_n = xi.split(H, dim=-1)
    h_r, h_z, h_n = hh.split(H, dim=-1)
    r = torch.sigmoid(x_r + h_r)
    z = torch.sigmoid(x_z + h_z)
    n = torch.tanh(x_n + r * (h_n + bias_hn))
    return (1.0 - z) * n + z * h


def gru_scan_reference(xi: torch.Tensor, weight_hh: torch.Tensor, bias_hn: torch.Tensor,
                       lengths: torch.Tensor) -> torch.Tensor:
    """The plain version of K3, on any device: the input projection xi
    (B, T, 3H), W_hh (3H, H), b_hn (H,) and lengths (B,) -> the outputs
    (B, T, H), the carry frozen and the output 0 past each length."""
    B, T, _ = xi.shape
    H = weight_hh.shape[1]
    mask = length_mask(lengths, T)
    h = xi.new_zeros((B, H))
    outs = []
    # unbind, not xi[:, t]: autograd then stacks the per-step gradients
    # once instead of filling and adding a full-size xi gradient per step
    for xi_t, keep in zip(xi.unbind(1), mask[..., None].unbind(1)):
        h_new = gru_cell(xi_t, h, weight_hh, bias_hn)
        h = torch.where(keep, h_new, h)
        outs.append(torch.where(keep, h_new, torch.zeros_like(h_new)))
    return torch.stack(outs, dim=1)


@dataclasses.dataclass(frozen=True)
class Plan:
    """The weight slices' layout: cs blocks a cluster, `units` = ceil(H /
    cs) hidden units a block, upt units a lane. The kernel's entry point
    takes (H, cs, upt) and picks the rest: the instantiation of that upt
    (its batch rows a cluster, where the slice sits), the clusters and the
    shared memory."""
    cs: int
    units: int
    upt: int


def launch_plan(H: int) -> Plan:
    """The layout for H units, the same both ways. H <= 512: one unit a
    lane, the fewest blocks of at most 32 units (a power of two), the slice
    in shared memory; 512 < H <= 1024: 16 blocks, two units a lane, the
    slice read from L2. Raises for H > 1024."""
    if H < 1:
        raise ValueError(f"no K3 launch for H {H}")
    if H <= 32 * MAX_CLUSTER:
        upt, cs = 1, 1 << max(0, math.ceil(math.log2(math.ceil(H / 32))))
    elif H <= 64 * MAX_CLUSTER:
        upt, cs = 2, MAX_CLUSTER
    else:
        raise ValueError(f"K3 takes hidden sizes up to {64 * MAX_CLUSTER}, not {H}")
    return Plan(cs, math.ceil(H / cs), upt)


def _slices(weight_hh: torch.Tensor, plan: Plan, backward: bool) -> torch.Tensor:
    """W_hh (3H, H) laid out as the kernel reads each block's slice: block
    c's unit slot l + 32 i (unit c U + l + 32 i; slots past the units zero)
    and gate g at row 96 i + 3 l + g; forward (cs, H, 96 upt) k-major,
    backward (cs, 96 upt, H) row-major."""
    H = weight_hh.shape[1]
    cs, U, slots = plan.cs, plan.units, 32 * plan.upt
    w = weight_hh.detach().reshape(3, H, H)
    if cs * U > H:
        w = F.pad(w, (0, 0, 0, cs * U - H))
    w = w.reshape(3, cs, U, H)
    if slots > U:
        w = F.pad(w, (0, 0, 0, slots - U))
    w = w.reshape(3, cs, plan.upt, 32, H)
    if backward:
        return w.permute(1, 2, 3, 0, 4).reshape(cs, 96 * plan.upt, H).contiguous()
    return w.permute(1, 4, 2, 3, 0).reshape(cs, H, 96 * plan.upt).contiguous()


def _lengths(lengths: torch.Tensor, B: int, device: torch.device) -> torch.Tensor:
    if lengths.device != device:
        raise ValueError(f"lengths are on {lengths.device}, the inputs on {device}")
    if tuple(lengths.shape) != (B,) or lengths.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"K3 takes lengths as int64 or int32 ({B},), not {lengths.dtype} "
                         f"{tuple(lengths.shape)}")
    return lengths.to(torch.int64).contiguous()


def _raise_if_failed(lib, rc: int, what: str, shape) -> None:
    if rc != 0:
        msg = lib.gru_scan_error_string(rc).decode()
        raise RuntimeError(f"gru_scan {what} launch failed: {msg} ({rc}) at (B, T, H) {shape}")


def _count() -> None:
    with _count_lock:
        gru_scan.launches += 1


def _kernel_forward(xi, weight_hh, bias_hn, lengths, save):
    """K3's forward launch: (y (B, T, H), gates (B, T, 4H) or empty)."""
    B, T, H3 = xi.shape
    H = H3 // 3
    dev = xi.device
    for name, x in (("weight_hh", weight_hh), ("bias_hn", bias_hn)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, xi on {dev}")
    if not xi.is_contiguous() or not bias_hn.is_contiguous():
        raise ValueError(f"K3 needs a contiguous xi and bias_hn (strides {xi.stride()}, "
                         f"{bias_hn.stride()})")
    lengths = _lengths(lengths, B, dev)
    y = torch.empty((B, T, H), dtype=torch.float32, device=dev)
    gates = torch.empty((B, T, 4 * H) if save else (0,), dtype=torch.float32, device=dev)
    plan = launch_plan(H)
    w = _slices(weight_hh, plan, backward=False)
    lib = kernels.load("gru_scan")
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.gru_scan_f32(xi.data_ptr(), w.data_ptr(), bias_hn.data_ptr(), lengths.data_ptr(),
                          B, T, H, plan.cs, plan.upt, y.data_ptr(),
                          gates.data_ptr() if save else None, stream)
    _raise_if_failed(lib, rc, "forward", (B, T, H))
    _count()
    return y, gates


def _kernel_backward(dy, y, gates, weight_hh, lengths):
    """K3's backward launch: (dxi, dhh), each (B, T, 3H)."""
    B, T, H = y.shape
    dev = y.device
    dy = dy.contiguous()
    lengths = _lengths(lengths, B, dev)
    dxi = torch.empty((B, T, 3 * H), dtype=torch.float32, device=dev)
    dhh = torch.empty_like(dxi)
    plan = launch_plan(H)
    w = _slices(weight_hh, plan, backward=True)
    lib = kernels.load("gru_scan")
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.gru_scan_bwd_f32(dy.data_ptr(), y.data_ptr(), gates.data_ptr(), w.data_ptr(),
                              lengths.data_ptr(), B, T, H, plan.cs, plan.upt, dxi.data_ptr(),
                              dhh.data_ptr(), stream)
    _raise_if_failed(lib, rc, "backward", (B, T, H))
    _count()
    return dxi, dhh


class _GruScan(torch.autograd.Function):
    """(xi, weight_hh, bias_hn, lengths, save) -> (y, gates): K3 forward,
    its companion backward; `save` stores the gates the backward needs."""

    @staticmethod
    def forward(xi, weight_hh, bias_hn, lengths, save):
        return _kernel_forward(xi, weight_hh, bias_hn, lengths, save)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, weight_hh, _, lengths, _ = inputs
        y, gates = output
        ctx.mark_non_differentiable(gates)
        ctx.save_for_backward(y, gates, weight_hh, lengths)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, _):
        y, gates, weight_hh, lengths = ctx.saved_tensors
        if gates.numel() == 0:
            raise RuntimeError("K3's forward stored no gates: it ran without a gradient")
        B, T, H = y.shape
        dxi, dhh = _kernel_backward(dy, y, gates, weight_hh, lengths)
        h_prev = F.pad(y[:, :-1], (0, 0, 1, 0))  # h_{t-1}: the output of every valid frame
        d_weight_hh = dhh.reshape(-1, 3 * H).T @ h_prev.reshape(-1, H)
        d_bias_hn = dhh[..., 2 * H:].sum((0, 1))
        return dxi, d_weight_hh, d_bias_hn, None, None

    @staticmethod
    def vmap(info, in_dims, xi, weight_hh, bias_hn, lengths, save):
        """Under torch.func.vmap (the expert-parallel zoo's stacked
        experts): one launch each."""
        outs = []
        for e in range(info.batch_size):
            args = [x if d is None else x.select(d, e).contiguous()
                    for x, d in zip((xi, weight_hh, bias_hn, lengths), in_dims)]
            wants = save or (torch.is_grad_enabled() and any(a.requires_grad for a in args[:3]))
            outs.append(_GruScan.apply(*args, wants))
        return tuple(torch.stack(o) for o in zip(*outs)), (0, 0)


def gru_scan(xi: torch.Tensor, weight_hh: torch.Tensor, bias_hn: torch.Tensor,
             lengths: torch.Tensor) -> torch.Tensor:
    """gru_scan_reference's function (same arguments, same return): K3 for
    CUDA float32 input, one launch forward and, where a gradient is
    wanted, one backward; the plain version for CPU input.

    The kernel takes xi (B, T, 3H) contiguous, weight_hh (3H, H), bias_hn
    (H,) contiguous and lengths (B,) int64 or int32, all float32 on xi's
    card, H <= 1024. Anything else raises.
    """
    if xi.device.type == "cpu":
        return gru_scan_reference(xi, weight_hh, bias_hn, lengths)
    if xi.device.type != "cuda":
        raise ValueError(f"gru_scan runs on cuda or cpu tensors, not {xi.device}")
    if xi.dtype != torch.float32 or weight_hh.dtype != torch.float32 or \
            bias_hn.dtype != torch.float32:
        raise TypeError(f"K3 takes float32 xi, weight_hh and bias_hn, not {xi.dtype}, "
                        f"{weight_hh.dtype} and {bias_hn.dtype}")
    H = weight_hh.shape[-1]
    if xi.ndim != 3 or xi.shape[-1] != 3 * H or tuple(weight_hh.shape) != (3 * H, H) or \
            tuple(bias_hn.shape) != (H,):
        raise ValueError(f"expected xi (B, T, {3 * H}), weight_hh {(3 * H, H)}, bias_hn "
                         f"({H},); got {tuple(xi.shape)}, {tuple(weight_hh.shape)}, "
                         f"{tuple(bias_hn.shape)}")
    B, T, _ = xi.shape
    if B == 0 or T == 0:
        return xi.new_zeros((B, T, H))
    save = torch.is_grad_enabled() and (xi.requires_grad or weight_hh.requires_grad
                                        or bias_hn.requires_grad)
    return _GruScan.apply(xi, weight_hh, bias_hn, lengths, save)[0]


gru_scan.launches = 0
