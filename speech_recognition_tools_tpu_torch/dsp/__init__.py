"""Front-ends (port of speech_recognition_tools_tpu/dsp)."""
