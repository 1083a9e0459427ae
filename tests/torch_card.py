"""The `card` fixture of the port's on-card tests.

On-card checks of the port are pytest tests beside the code's CPU tests:
each takes `card`, the CUDA device, and skips where there is none. On an
H100 run their files whole (tests/conftest.py imports JAX, which the card's
machine lacks), e.g.
`python -m pytest --noconftest tests/test_torch_ctc_prefix_kernel.py
tests/test_torch_gru_kernel.py tests/test_torch_speech_llm.py`.
A test module takes the fixture with `from torch_card import card`.
"""

import pytest
import torch


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")
    return torch.device("cuda")
