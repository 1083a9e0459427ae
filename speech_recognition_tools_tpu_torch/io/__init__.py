"""Data I/O: wav, scp, Kaldi ark, weights carried over from the JAX package."""
