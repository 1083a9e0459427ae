"""Acoustic models (port of speech_recognition_tools_tpu/models)."""
