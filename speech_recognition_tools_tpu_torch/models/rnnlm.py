"""Recurrent language model for shallow fusion in beam search.

Port of speech_recognition_tools_tpu/models/rnnlm.py::RNNLM with its GRU
cell: Embed -> masked GRU stack -> Dense to vocab logits (the reference
fuses a 1 x 1000 RNNLM at lm-weight 1.0, conf/lm.yaml and decode.yaml).
io/jax_params.py::rnnlm_from_jax carries a flax tree over.

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
