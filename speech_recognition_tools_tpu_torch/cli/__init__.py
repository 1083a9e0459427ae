"""Command-line tools (port of speech_recognition_tools_tpu/cli)."""
