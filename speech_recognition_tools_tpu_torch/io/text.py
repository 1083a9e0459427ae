"""Character vocabulary and transcripts for e2e ASR (host code).

Copy of speech_recognition_tools_tpu/io/text.py::build_char_vocab,
decode_tokens, load_vocab and read_text_file (the data2json / char-dict
stage of the reference's ESPnet recipes, run_fdlp_e1.sh:305-331). The JAX
package's io/__init__ imports jax, so the port keeps its own copy.
"""

import json


def build_char_vocab(texts):
    """Char vocabulary: id 0 = <blank> (CTC), 1 = <unk>, then the ESPnet
    <space> token, then sorted non-space chars, last id = <sos/eos>."""
    chars = sorted({c for t in texts for c in t if c != " "})
    vocab = {"<blank>": 0, "<unk>": 1, "<space>": 2}
    for c in chars:
        vocab[c] = len(vocab)
    vocab["<sos/eos>"] = len(vocab)
    return vocab


def decode_tokens(tokens, vocab):
    inv = {v: k for k, v in vocab.items()}
    out = []
    for t in tokens:
        s = inv.get(int(t), "")
        if s in ("<blank>", "<sos/eos>", "<unk>"):
            continue
        if s == "<space>":
            s = " "
        out.append(s)
    return "".join(out)


def load_vocab(path):
    with open(path) as f:
        return json.load(f)


def read_text_file(path):
    """Kaldi text file: 'utt transcription ...' -> {utt: text}."""
    out = {}
    with open(path) as f:
        for line in f:
            parts = line.strip().split(None, 1)
            if len(parts) == 2:
                out[parts[0]] = parts[1]
    return out
