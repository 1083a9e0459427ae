"""Device selection and CUDA numerics shared by the port's entry points."""

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch.device an entry point runs on.

    "cuda" (the default of every entry point) needs a card and raises
    without one: the port never carries on quietly on the CPU. This only
    looks the device up; it changes no global setting.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but torch.cuda.is_available() is False; "
                "pass device='cpu' to run on the CPU"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (use 'cuda' or 'cpu')")
    return dev


def configure_cuda() -> None:
    """Switch TF32 off, process-wide, for CUDA matmuls and cuDNN, and make
    bfloat16 matmuls reduce in float32.

    The JAX package runs every float32 contraction at Precision.HIGHEST
    (full float32), and the port is held to it. Its bfloat16 products
    (compute_dtype "bfloat16") accumulate in float32, as XLA's do, where
    torch's default lets cuBLAS reduce them in bfloat16
    (`allow_bf16_reduced_precision_reduction`, switched off here). The
    entry points that run on a card (`fdlp_lags` / `fdlp_spectrogram_batch`,
    which the featgen CLI runs, `RNNClassifier`, `TransformerASR` and
    `RNNLM`) call this when their device is CUDA, and say so; it is the one
    place the port changes these `torch.backends` flags.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
