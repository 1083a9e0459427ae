"""Decoding (port of speech_recognition_tools_tpu/decode): CTC prefix
scoring, the batched joint CTC/attention beam search, the look-ahead word
LM, greedy and Viterbi decoding, log-likelihood export, and the hybrid
WFST stack (graph build, the native decoder, lattices)."""

from speech_recognition_tools_tpu_torch.decode.wordlm import LookaheadWordLM  # noqa: F401
