"""Signal-processing ops of the FDLP front-end (port of speech_recognition_tools_tpu/ops)."""
