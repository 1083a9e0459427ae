"""Inference helpers (port of speech_recognition_tools_tpu/infer)."""
