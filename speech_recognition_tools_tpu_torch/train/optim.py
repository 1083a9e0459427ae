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

The JAX package's other four names give `ClipRule`: the same clipping,
then one of optax's rules at its defaults, then p + (-lr) * update with
the injected float32 rate (train_am's form):

  - adadelta (rho 0.9, eps 1e-6): e_g = (1 - rho) g^2 + rho e_g, the
    update sqrt(e_x + eps) / sqrt(e_g + eps) * g, then
    e_x = (1 - rho) update^2 + rho e_x;
  - sgd (no momentum): the update is g;
  - adagrad (initial accumulator 0.1, eps 1e-7; torch.optim.Adagrad
    starts at 0 with eps 1e-10 outside the root): s = s + g^2, the update
    g / sqrt(s + eps) where s > 0, else 0;
  - rmsprop (decay 0.9, eps 1e-8 inside the root, not centered;
    torch.optim.RMSprop decays by 0.99 and adds eps outside the root):
    nu = (1 - decay) g^2 + decay nu, the update g / sqrt(nu + eps).

io/jax_params.py::optim_state_to_jax writes any of these states in optax's
layout.

Parallel training sets two hooks on either optimizer: `grad_group`, a
data-parallel process group whose gradients are summed before the update,
and `norm_sq`, which takes the global norm's squares over the shards of
tensor- or pipeline-parallel parameters (each replicated one once).
"""

from collections.abc import Callable

import numpy as np
import torch

from speech_recognition_tools_tpu_torch.utils.profiling import span

B1, EPS = 0.9, 1e-8  # optax.adam's defaults, which every caller takes


def f32(x: float) -> float:
    """x rounded to float32, as a Python float (exact in double)."""
    return float(np.float32(x))


def global_norm(grads: list, norm_sq=None) -> torch.Tensor:
    """sqrt(sum_i |g_i|^2); `norm_sq` (the per-tensor squared norms ->
    their total) sums them over sharded parameters' ranks instead
    (parallel/tp.py, parallel/pp.py layouts: each replicated tensor counted
    once)."""
    norms = torch.stack(torch._foreach_norm(grads))
    sq = norms * norms
    return (sq.sum() if norm_sq is None else norm_sq(sq)).sqrt()


def clip_by_global_norm(g: list, threshold: float | None, norm_sq=None):
    """(the gradients as optax.clip_by_global_norm(threshold) leaves them,
    their global norm before clipping as a float); None clips nothing."""
    norm = global_norm(g, norm_sq)
    with span("optim.wait"):
        gnorm = norm.item()
    if threshold is not None and not gnorm < threshold:
        g = torch._foreach_mul(torch._foreach_div(g, gnorm), threshold)
    return g, gnorm


def reduce_gradients(g: list, group) -> list:
    """The gradients summed over a data-parallel `group` (one flat
    all-reduce), as GSPMD sums the per-shard gradients of a sharded batch."""
    from speech_recognition_tools_tpu_torch.parallel import collectives

    if collectives.group_size(group) == 1:
        return g
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    flat = collectives.all_reduce(_flatten_dense_tensors(g), group)
    return list(_unflatten_dense_tensors(flat, g))


class _Parallel:
    """The parallel hooks of an optimizer: `grad_group` (a data-parallel
    process group whose gradients are summed before the update) and
    `norm_sq` (the clipping norm's reduction over sharded parameters);
    both None for one process."""

    grad_group = None
    norm_sq = None

    def _prepare(self, keys, grads):
        g = reduce_gradients([grads[k] for k in keys], self.grad_group)
        return clip_by_global_norm(g, self.clip_threshold, self.norm_sq)


class ClipAdam(_Parallel):
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

    global_norm = staticmethod(global_norm)

    @torch.no_grad()
    def apply(self, params: dict, grads: dict, state: dict):
        """One update, in place, of `params` and of the moments in `state`
        from `grads` (dicts with the keys of init's). Returns (the state
        with its count advanced, the global norm of the gradients before
        clipping, as a float)."""
        keys = list(params)
        g, gnorm = self._prepare(keys, grads)
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


# each rule's state slots, in optax's names
RULES = {"adadelta": ("e_g", "e_x"), "sgd": (), "adagrad": ("sum_of_squares",),
         "rmsprop": ("nu",)}
ADADELTA_RHO, ADADELTA_EPS = 0.9, 1e-6
ADAGRAD_INIT, ADAGRAD_EPS = 0.1, 1e-7
RMSPROP_DECAY, RMSPROP_EPS = 0.9, 1e-8


class ClipRule(_Parallel):
    """Global-norm clipping followed by optax's adadelta, sgd, adagrad or
    rmsprop at its defaults, over a dict of parameters, with a fixed rate
    held as inject_hyperparams holds it (in float32). The state is a dict:
    "count", "learning_rate" and a dict of tensors per slot of RULES."""

    def __init__(self, name: str, learning_rate: float, clip_threshold: float | None = 1.0):
        if name not in RULES:
            raise ValueError(f"Unknown optimizer {name}")
        self.name = name
        self.learning_rate = learning_rate
        self.clip_threshold = clip_threshold

    def init(self, params: dict) -> dict:
        fill = ADAGRAD_INIT if self.name == "adagrad" else 0.0
        with torch.no_grad():
            state = {slot: {k: torch.full_like(p, fill) for k, p in params.items()}
                     for slot in RULES[self.name]}
        return dict(state, count=0, learning_rate=f32(float(self.learning_rate)))

    @torch.no_grad()
    def apply(self, params: dict, grads: dict, state: dict):
        """One update in place, as ClipAdam.apply."""
        keys = list(params)
        g, gnorm = self._prepare(keys, grads)
        slots = {s: [state[s][k] for k in keys] for s in RULES[self.name]}
        if self.name == "adadelta":
            rho, eps = ADADELTA_RHO, ADADELTA_EPS
            e_g, e_x = slots["e_g"], slots["e_x"]
            torch._foreach_mul_(e_g, rho)
            torch._foreach_add_(e_g, torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - rho))
            num = torch._foreach_sqrt(torch._foreach_add(e_x, eps))
            den = torch._foreach_sqrt(torch._foreach_add(e_g, eps))
            upd = torch._foreach_mul(torch._foreach_div(num, den), g)
            torch._foreach_mul_(e_x, rho)
            torch._foreach_add_(e_x, torch._foreach_mul(torch._foreach_mul(upd, upd), 1.0 - rho))
        elif self.name == "sgd":
            upd = list(g)
        elif self.name == "adagrad":
            s = slots["sum_of_squares"]
            torch._foreach_add_(s, torch._foreach_mul(g, g))
            inv = [torch.where(t > 0, torch.rsqrt(t + ADAGRAD_EPS), torch.zeros_like(t))
                   for t in s]
            upd = torch._foreach_mul(inv, g)
        else:
            nu = slots["nu"]
            torch._foreach_mul_(nu, RMSPROP_DECAY)
            torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g),
                                                      1.0 - RMSPROP_DECAY))
            upd = torch._foreach_mul(torch._foreach_rsqrt(torch._foreach_add(nu, RMSPROP_EPS)),
                                     g)
        torch._foreach_mul_(upd, -state["learning_rate"])
        torch._foreach_add_([params[k] for k in keys], upd)
        return dict(state, count=state["count"] + 1), gnorm


def make_optimizer(name: str, learning_rate, clip_threshold: float | None = 1.0):
    """As the JAX make_optimizer: a threshold of 0 or None chains no clip."""
    name = name.lower()
    if name == "adam":
        return ClipAdam(learning_rate, clip_threshold or None)
    return ClipRule(name, learning_rate, clip_threshold or None)
