"""Optimizers, written out as optax computes them.

Port of speech_recognition_tools_tpu/train/optim.py. `make_optimizer`
returns `ClipAdam`, the transformation
`optax.chain(optax.clip_by_global_norm(clip), optax.adam(lr))` (no chain
when clip is None or 0; ClipAdam itself clips at any number, 0 included,
as train_e2e's chain does), written out so that every step follows optax's
arithmetic rather than torch.optim's:

  - clipping: with the global norm n = sqrt(sum_i |g_i|^2), the gradients
    become (g / n) * clip when n >= clip and stay as they are below it
    (torch's clip_grad_norm_ scales by clip / (n + 1e-6) whenever n > clip);
  - Adam: mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu, the count k
    incremented first, then the update mu / (1 - b1^k) divided by
    sqrt(nu / (1 - b2^k)) + eps (eps outside the root, eps_root 0);
  - the step: p + (-lr) * update, where a schedule is read at the count
    *before* its increment, as `optax.scale_by_schedule` reads it: the
    k-th update uses schedule(k - 1).

The state is a dict: "count" (an int), the moments "mu" and "nu" (dicts
of tensors keyed like the parameters) and, for a fixed learning rate,
"learning_rate": by default a float rounded to float32, the hyperparameter
that the JAX trainer's `optax.inject_hyperparams` holds and its LR-revert
rule changes; with `inject=False` the rate as given, as plain
optax.adam(lr) scales by it (train_lm). io/jax_params.py::adam_state_to_jax
writes the state in optax's layout.
Only Adam is ported; the JAX package's other four names raise
NotImplementedError.
"""

from collections.abc import Callable

import numpy as np
import torch

NOT_PORTED = ("adadelta", "sgd", "adagrad", "rmsprop")
B1, EPS = 0.9, 1e-8  # optax.adam's defaults, which every caller takes


def f32(x: float) -> float:
    """x rounded to float32, as a Python float (exact in double)."""
    return float(np.float32(x))


class ClipAdam:
    """Global-norm clipping followed by Adam, over a dict of parameters.

    learning_rate: a float, or a schedule count -> float; b2: 0.999 as
    optax.adam's default (train_am), 0.98 for train_e2e; inject: whether a
    fixed rate is held as inject_hyperparams holds it (in float32).
    """

    def __init__(self, learning_rate: float | Callable[[int], float],
                 clip_threshold: float | None = 1.0, *, b2: float = 0.999,
                 inject: bool = True):
        self.learning_rate = learning_rate
        self.inject = inject
        # None: no clipping; a number, 0 included, clips as
        # optax.clip_by_global_norm does (at 0 every update is zero)
        self.clip_threshold = clip_threshold
        self.b2 = b2

    @property
    def scheduled(self) -> bool:
        return callable(self.learning_rate)

    def init(self, params: dict) -> dict:
        with torch.no_grad():
            state = {
                "count": 0,
                "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()},
            }
        if not self.scheduled:
            lr = float(self.learning_rate)
            state["learning_rate"] = f32(lr) if self.inject else lr
        return state

    @staticmethod
    def global_norm(grads: list) -> torch.Tensor:
        norms = torch.stack(torch._foreach_norm(grads))
        return (norms * norms).sum().sqrt()

    @torch.no_grad()
    def apply(self, params: dict, grads: dict, state: dict):
        """One update, in place, of `params` and of the moments in `state`
        from `grads` (dicts with the keys of init's). Returns (the state
        with its count advanced, the global norm of the gradients before
        clipping, as a float)."""
        keys = list(params)
        g = [grads[k] for k in keys]
        gnorm = self.global_norm(g).item()
        if self.clip_threshold is not None and not gnorm < self.clip_threshold:
            g = torch._foreach_mul(torch._foreach_div(g, gnorm), self.clip_threshold)
        b1, b2 = B1, self.b2
        mu = [state["mu"][k] for k in keys]
        nu = [state["nu"][k] for k in keys]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - b1))
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - b2))
        count = state["count"] + 1
        # Python scalars meet the tensors in the tensors' dtype, as optax
        # casts the bias corrections and the rate to the updates' dtype
        mu_hat = torch._foreach_div(mu, 1.0 - b1**count)
        den = torch._foreach_div(nu, 1.0 - b2**count)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, EPS)
        upd = torch._foreach_div(mu_hat, den)
        if self.scheduled:
            lr = self.learning_rate(state["count"])
        else:
            lr = state["learning_rate"]
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_([params[k] for k in keys], upd)
        return dict(state, count=count), gnorm


def make_optimizer(name: str, learning_rate, clip_threshold: float | None = 1.0):
    name = name.lower()
    if name == "adam":
        # as the JAX make_optimizer, a threshold of 0 or None chains no clip
        return ClipAdam(learning_rate, clip_threshold or None)
    if name in NOT_PORTED:
        raise NotImplementedError(f"optimizer {name!r} is not yet ported (adam only)")
    raise ValueError(f"Unknown optimizer {name}")
