"""Character vocabulary and transcripts for e2e ASR (host code).

Copy of speech_recognition_tools_tpu/io/text.py::build_char_vocab,
build_word_vocab, encode_words, encode_text, decode_tokens, save_vocab,
load_vocab and read_text_file (the data2json / char-dict
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


def build_word_vocab(texts, size=65000):
    """Word vocabulary for word RNNLMs (the reference's use_wordlm=true
    branch caps it at lm_vocabsize, e2e/wsj/run_fdlp_e1.sh:39): the size-2
    most frequent words (ties broken alphabetically) under {'<eos>': 0,
    '<unk>': 1}, the conventions decode/wordlm.py and the word-LM trainer
    share."""
    from collections import Counter

    counts = Counter(w for t in texts for w in t.split())
    vocab = {"<eos>": 0, "<unk>": 1}
    for w, _ in sorted(counts.items(), key=lambda kv: (-kv[1], kv[0])):
        if len(vocab) >= size:
            break
        vocab[w] = len(vocab)
    return vocab


def encode_words(text, vocab):
    unk = vocab["<unk>"]
    return [vocab.get(w, unk) for w in text.split()]


def encode_text(text, vocab):
    unk = vocab["<unk>"]
    space = vocab.get("<space>", vocab.get(" ", unk))
    return [space if c == " " else vocab.get(c, unk) for c in text]


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


def save_vocab(vocab, path):
    with open(path, "w") as f:
        json.dump(vocab, f, indent=0, ensure_ascii=False)


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
