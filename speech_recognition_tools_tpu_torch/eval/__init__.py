"""Evaluation (port of speech_recognition_tools_tpu/eval): word error rates."""
