"""An LLM-based recogniser: an audio tower, a projector, and a
mixture-of-experts LLM decoder (models/moe_lm.py) that the batched beam
search (decode/beam_jit.py) runs through its latent cache.

    feats -> TransformerEncoder (float32) -> memory (B, T2, adim)
          -> stack `stack` frames (B, T2 // stack, stack * adim)
          -> projector: LayerNorm, Linear, GELU, Linear (the LLM's dtype)
          -> the audio prefix (B, P, hidden), one position per stack
    LLM input: [audio prefix, sos, text tokens]

The audio tower is models/transformer_asr.py's encoder; the projector is
Kimi-VL's MLP projector laid over audio frames. An utterance's prefix
holds enc_len // stack positions (a last odd frame is dropped). Prefixes
are left-padded to the batch's T2 // stack slots, so that every row's text
starts at one slot; each row's RoPE positions start at its first real
position (models/moe_lm.py). There is no CTC head: `encode` returns None
for the CTC logits and the search runs without the CTC prefix score.

`SpeechLLM` is the model protocol the search calls: `cfg` (vocab_size,
sos_id, eos_id, cdtype), `encode`, `decode_init_cache` (one prefill of the
B utterances' prefixes, then the latent cache expanded to the K beams of
each), `decode_incremental` (one cached token a beam) and `reorder_cache`
(the beams' text slots only: the prefix slots are equal in the K beams of
an utterance). The search must run with incremental=True.

`save` and `load` write and read a model directory with
train/checkpoint.py (config.json's "model" is "speech_llm").
"""

import os
from dataclasses import asdict, dataclass, field

import torch
from torch import nn
from torch.nn import functional as F

from speech_recognition_tools_tpu_torch.device import configure_cuda, resolve_device
from speech_recognition_tools_tpu_torch.models.moe_lm import MoELM, MoELMConfig
from speech_recognition_tools_tpu_torch.models.transformer_asr import (
    TransformerASRConfig,
    TransformerEncoder,
)
from speech_recognition_tools_tpu_torch.utils.profiling import span

FAMILY = "speech_llm"


@dataclass(frozen=True)
class SpeechLLMConfig:
    llm: MoELMConfig = field(default_factory=MoELMConfig)
    # the audio tower's widths (its vocab_size and decoder fields are unused)
    encoder: TransformerASRConfig = field(
        default_factory=lambda: TransformerASRConfig(dropout=0.0))
    idim: int = 80  # feature dimension
    stack: int = 2  # encoder frames per prefix position
    sos_id: int = -1  # -1: vocab_size - 2
    eos_id: int = -1  # -1: vocab_size - 1

    def __post_init__(self):
        V = self.llm.vocab_size
        object.__setattr__(self, "sos_id", V - 2 if self.sos_id < 0 else self.sos_id)
        object.__setattr__(self, "eos_id", V - 1 if self.eos_id < 0 else self.eos_id)

    @property
    def vocab_size(self) -> int:
        return self.llm.vocab_size

    @property
    def cdtype(self) -> torch.dtype:
        return self.llm.torch_dtype

    def to_dict(self) -> dict:
        return {"model": FAMILY, "llm": self.llm.to_dict(), "encoder": asdict(self.encoder),
                "feature_dim": self.idim, "stack": self.stack, "sos_id": self.sos_id,
                "eos_id": self.eos_id}

    @classmethod
    def from_dict(cls, d: dict) -> "SpeechLLMConfig":
        return cls(llm=MoELMConfig.from_dict(d["llm"]),
                   encoder=TransformerASRConfig(**dict(d["encoder"], dropout=0.0)),
                   idim=d["feature_dim"], stack=d["stack"], sos_id=d["sos_id"],
                   eos_id=d["eos_id"])


class Projector(nn.Module):
    """LayerNorm (statistics in float32), Linear, GELU, Linear, in `dtype`."""

    def __init__(self, in_dim: int, out_dim: int, dtype, *, device=None):
        super().__init__()
        self.pre_norm = nn.LayerNorm(in_dim, eps=1e-5, dtype=dtype, device=device)
        self.linear_1 = nn.Linear(in_dim, out_dim, dtype=dtype, device=device)
        self.linear_2 = nn.Linear(out_dim, out_dim, dtype=dtype, device=device)

    def forward(self, x):
        n = self.pre_norm
        h = F.layer_norm(x.float(), n.normalized_shape, n.weight.float(), n.bias.float(),
                         n.eps).to(n.weight.dtype)
        return self.linear_2(F.gelu(self.linear_1(h)))


class SpeechLLM(nn.Module):
    """`device` "meta" builds the modules without memory (see `empty`)."""

    def __init__(self, cfg: SpeechLLMConfig = SpeechLLMConfig(), *, device="cuda"):
        super().__init__()
        dev = torch.device(device) if str(device) == "meta" else resolve_device(device)
        if dev.type == "cuda":
            configure_cuda()
        self.cfg = cfg
        self.encoder = TransformerEncoder(cfg.encoder, cfg.idim, device=dev)
        self.projector = Projector(cfg.stack * cfg.encoder.adim, cfg.llm.hidden_size,
                                   cfg.llm.torch_dtype, device=dev)
        self.llm = MoELM(cfg.llm, device=dev)

    @classmethod
    def empty(cls, cfg: SpeechLLMConfig, device="cuda") -> "SpeechLLM":
        """The model on `device` with its parameters allocated there and not
        initialised (built on "meta", then `to_empty`): nothing of its size
        is drawn on the host. The caller loads or draws every parameter."""
        dev = resolve_device(device)
        if dev.type == "cuda":
            configure_cuda()
        return cls(cfg, device="meta").to_empty(device=dev).eval()

    def encode_audio(self, feats, lengths):
        """(B, T, idim), (B,) -> the audio tower's memory (B, T2, adim)
        float32, enc_len (B,)."""
        with span("asr.encode"):
            return self.encoder(feats, lengths)

    def encode(self, feats, lengths):
        """(B, T, idim), (B,) -> the left-padded audio prefixes (B, S,
        hidden) in the LLM's dtype, S = T2 // stack; their lengths P (B,);
        None (no CTC head)."""
        memory, enc_len = self.encode_audio(feats, lengths)
        B, T2, A = memory.shape
        k = self.cfg.stack
        S = T2 // k
        x = self.projector(memory[:, : S * k].reshape(B, S, k * A))
        P = torch.div(enc_len, k, rounding_mode="floor")
        src = torch.arange(S, device=x.device)[None, :] - (S - P)[:, None]  # slot -> position
        x = x.gather(1, src.clamp_min(0)[..., None].expand(-1, -1, x.shape[-1]))
        return x.masked_fill((src < 0)[..., None], 0.0), P, None

    def decode_init_cache(self, dummy_tokens, memory, enc_len):
        """One prefill of the B prefixes memory (B, S, hidden) (`encode`'s),
        then the latent cache for the dummy_tokens.shape[0] = B * K beams
        (utterance-major), S + dummy_tokens.shape[1] slots long, every beam
        holding its utterance's prefix (on the card, the slots of the
        LLM's decode buffer: models/moe_lm.py). Span `llm.prefill` counts
        the prefix positions prefilled."""
        B, S, _ = memory.shape
        K = dummy_tokens.shape[0] // B
        pad = S - enc_len
        with span("llm.prefill") as sp:
            if sp:
                sp.n = enc_len.sum()
            prefix, _ = self.llm.prefill(memory, pad, S)
        cache = self.llm.decode_cache(B * K, S + dummy_tokens.shape[1],
                                      pad.repeat_interleave(K))
        cache["kv"].unflatten(1, (B, K))[:, :, :, :S] = prefix["kv"][:, :, None]
        cache["len"] = cache["prefix"] = S
        cache["routes"] = prefix["routes"]  # the prefill's, (layers, B * S, k)
        return cache

    def decode_incremental(self, last_tokens, pos, memory, enc_len, cache, pe_len=None):
        """last_tokens (N, 1) at text position `pos` (0 is sos) -> logits
        (N, 1, V) float32; the cache advanced in place. memory, enc_len and
        pe_len are the protocol's and unused: the prefix is in the cache and
        RoPE needs no table."""
        del memory, enc_len, pe_len
        if cache["len"] != cache["prefix"] + pos:
            raise ValueError(f"position {pos} is not the cache's next ({cache['len']} slots "
                             f"filled after a prefix of {cache['prefix']})")
        return self.llm.step(last_tokens[:, 0], cache)[:, None]

    def reorder_cache(self, cache, rows):
        return self.llm.reorder_cache(cache, rows, fixed=cache["prefix"])


def _tree(state: dict) -> dict:
    tree = {}
    for name, t in state.items():
        node = tree
        *path, leaf = name.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = t.detach().float().cpu().numpy()
    return tree


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


def save(model: SpeechLLM, directory: str, tag: str = "final") -> str:
    """The model as `<directory>/<tag>/` (train/checkpoint.py's layout: its
    state_dict as a tree split at the dots, float32 arrays)."""
    from speech_recognition_tools_tpu_torch.train.checkpoint import save_checkpoint

    return save_checkpoint(directory, tag, _tree(model.state_dict()), model.cfg.to_dict())


def is_speech_llm(config: dict) -> bool:
    return config.get("model") == FAMILY


def load(path: str, device="cuda") -> SpeechLLM:
    """The model of a checkpoint `save` wrote (path `<directory>/<tag>`),
    on `device`, in eval mode: built empty there, then loaded."""
    from speech_recognition_tools_tpu_torch.train.checkpoint import load_checkpoint

    payload, cfg_d = load_checkpoint(path)
    if not is_speech_llm(cfg_d):
        raise ValueError(f"{os.path.join(path, 'config.json')} is not a {FAMILY} checkpoint")
    model = SpeechLLM.empty(SpeechLLMConfig.from_dict(cfg_d), device)
    state = {k: torch.tensor(v) for k, v in _flat(payload["params"]).items()}
    model.load_state_dict(state)
    return model
