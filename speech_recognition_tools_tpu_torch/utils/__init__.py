"""Feature utilities (port of speech_recognition_tools_tpu/utils)."""
