"""Training layer (port of speech_recognition_tools_tpu/train): masked
losses, optax-arithmetic Adam, the LR-revert trainer, checkpoints in the
JAX package's layout."""
