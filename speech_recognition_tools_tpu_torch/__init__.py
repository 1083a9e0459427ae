"""PyTorch/CUDA port of speech_recognition_tools_tpu.

The package mirrors the JAX package's layout (ops/, dsp/, models/,
utils/, infer/, io/, cli/) so each module's counterpart is easy to find.
It imports torch, numpy and scipy, and nothing of JAX or of the JAX
package. Hand-written CUDA kernels live in csrc/ and are built at first
use (kernels.py). Entry points take a `device` argument that defaults to
"cuda"; pass device="cpu" to run on the CPU.
"""
