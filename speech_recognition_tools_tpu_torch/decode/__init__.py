"""Decoding (port of speech_recognition_tools_tpu/decode): CTC prefix
scoring and the batched joint CTC/attention beam search."""
