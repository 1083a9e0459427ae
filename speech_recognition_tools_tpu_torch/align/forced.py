"""The HMM topology and the lexicon reader of the hybrid branch's forced
aligner, which the decoding graph (decode/graph.py) shares.

Copy of speech_recognition_tools_tpu/align/forced.py::HmmTopology and
read_lexicon (host code). The aligner itself (utterance_states,
equal_align, viterbi_align_batch, realign_corpus) is not yet ported.
"""

import numpy as np


class HmmTopology:
    """Per-phone HMM topology + pdf numbering shared by the aligner and
    the decoding graph (decode/graph.py).

    pdf = base[phone] + hmm_state. With uniform state counts this
    degenerates to the legacy convention pdf = phone * states_per_phone
    + state, so existing alignments/graphs are unchanged unless the new
    knobs are used:

      silence_states: the silence phone gets its own (longer) chain —
        the Kaldi-topology tier where silence is a 5-state HMM while
        speech phones are 3-state (run_get_hq_ali.sh's topology via
        prepare_lang).
      wpd_silence: word-position-dependent silence — utterance-boundary
        silence gets a DISTINCT pdf block (a virtual phone id
        `edge_silence_phone`) from inter-word silence, so the AM can
        model long endpoint silences separately from short pauses.
    """

    def __init__(self, num_phones, states_per_phone=1, silence_phone=None,
                 silence_states=None, wpd_silence=False):
        self.silence_phone = silence_phone
        self.wpd_silence = bool(wpd_silence) and silence_phone is not None
        P = num_phones + (1 if self.wpd_silence else 0)
        self.num_phones = P
        self.edge_silence_phone = (
            num_phones if self.wpd_silence else silence_phone
        )
        st = np.full(P, states_per_phone, np.int32)
        if silence_phone is not None and silence_states:
            st[silence_phone] = silence_states
            if self.wpd_silence:
                st[self.edge_silence_phone] = silence_states
        self._states = st
        self.base = np.concatenate(
            [[0], np.cumsum(st)]
        ).astype(np.int32)
        self.num_pdfs = int(self.base[-1])

    def states(self, p):
        return int(self._states[p])

    def pdf(self, p, k):
        return int(self.base[p]) + k


def read_lexicon(path: str) -> dict:
    """Parse 'word phone-id [phone-id ...]' lines -> {word: [ids]} (the
    one lexicon format every aligner entry point shares)."""
    lexicon = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if parts:
                lexicon[parts[0]] = [int(x) for x in parts[1:]]
    return lexicon
