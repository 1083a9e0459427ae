"""Native forced alignment (flat start + Viterbi realignment), the
in-framework replacement for the reference's external Kaldi GMM alignment
pipeline (port of speech_recognition_tools_tpu/align)."""

from speech_recognition_tools_tpu_torch.align.forced import (  # noqa: F401
    HmmTopology,
    equal_align,
    min_align_frames,
    read_lexicon,
    realign_corpus,
    trailing_optional,
    utterance_states,
    viterbi_align_batch,
)
