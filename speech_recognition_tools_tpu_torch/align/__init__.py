"""Forced-alignment helpers (port of speech_recognition_tools_tpu/align)."""
