"""Recurrent language model for shallow fusion in beam search.

Port of speech_recognition_tools_tpu/models/rnnlm.py::RNNLM with its GRU
cell, and of lm_loss: Embed -> masked GRU stack -> Dense to vocab logits
(the reference fuses a 1 x 1000 RNNLM at lm-weight 1.0, conf/lm.yaml and
decode.yaml). io/jax_params.py::rnnlm_from_jax and rnnlm_to_jax carry a
flax tree over and back.

`forward` scores a padded batch of token sequences, as the JAX module
does. `step` advances a carried state by one token per row: the beam
search keeps each hypothesis's state and reorders it with the beams, where
the JAX package's fusion scorer (make_jit_fusion_scorer) reruns the GRU
over the whole token buffer every step. The logits at position s depend
only on tokens[0..s], so both compute the same scores. The 'lstm' cell is
not ported.
"""

import torch
from torch import nn

from speech_recognition_tools_tpu_torch.device import configure_cuda, resolve_device
from speech_recognition_tools_tpu_torch.models import flax_init
from speech_recognition_tools_tpu_torch.models.recurrent import GRUStack


class RNNLM(nn.Module):
    """`device` defaults to "cuda" and raises without a card; pass "cpu" to
    build the model on the CPU. On CUDA it switches TF32 off process-wide
    (device.configure_cuda)."""

    def __init__(self, vocab_size: int, embed_dim: int = 256, hidden: int = 1000,
                 layers: int = 1, cell: str = "gru", *, device="cuda"):
        super().__init__()
        if cell != "gru":
            raise NotImplementedError(f"RNNLM cell={cell!r} is not yet ported (gru only)")
        dev = resolve_device(device)
        if dev.type == "cuda":
            configure_cuda()
        self.layers, self.hidden = layers, hidden
        self.embed = nn.Embedding(vocab_size, embed_dim, device=dev)
        self.rnn = GRUStack(embed_dim, layers, hidden, device=dev)
        self.output = nn.Linear(hidden, vocab_size, device=dev)

    def reset_parameters(self, generator: torch.Generator | None = None):
        """Draw every parameter as the JAX model's `init` does (flax's Embed
        N(0, 1 / embed_dim), the GRU cells' and the output Dense's
        defaults), from `generator` (a CPU torch.Generator) in a fixed
        order."""
        flax_init.normal_(self.embed.weight, self.embed.embedding_dim**-0.5, generator)
        for layer in self.rnn.layers:
            layer.reset_parameters(generator)
        flax_init.dense_(self.output, generator)

    def forward(self, tokens: torch.Tensor, lengths: torch.Tensor | None = None):
        """tokens (B, U), -1 padded -> next-token logits (B, U, V)."""
        if lengths is None:
            lengths = torch.full((tokens.shape[0],), tokens.shape[1], device=tokens.device)
        return self.output(self.rnn(self.embed(tokens.clamp_min(0)), lengths))

    def init_state(self, batch: int) -> torch.Tensor:
        """The zero carry (layers, batch, hidden) before the first token."""
        w = self.output.weight
        return w.new_zeros((self.layers, batch, self.hidden))

    def step(self, tokens: torch.Tensor, state: torch.Tensor):
        """Consume one token per row: tokens (N,), state (layers, N, H) ->
        (next-token logits (N, V), new state)."""
        state = self.rnn.step(self.embed(tokens.clamp_min(0)), state)
        return self.output(state[-1]), state


def lm_loss(model: RNNLM, tokens: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Next-token cross-entropy over the valid positions of -1-padded
    sequences tokens (B, U) with lengths (B,): the targets are the tokens
    shifted by one, and the mean runs over the B x (length - 1) of them."""
    logits = model(tokens[:, :-1], lengths - 1)
    tgt = tokens[:, 1:]
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, tgt.clamp_min(0)[..., None])[..., 0]
    valid = (torch.arange(tgt.shape[1], device=tgt.device)[None, :]
             < (lengths - 1)[:, None]).to(nll.dtype)
    return (nll * valid).sum() / valid.sum().clamp_min(1)
