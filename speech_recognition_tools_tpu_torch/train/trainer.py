"""Generic trainer with the reference's LR-halve-and-revert schedule.

Port of speech_recognition_tools_tpu/train/trainer.py. After each epoch, if
the dev loss regresses by more than `lr_tol` (relative), the learning rate
is multiplied by `lrr` and the weights go back to the best epoch's host
snapshot. Like the reference (and the JAX trainer), the optimizer moments
are deliberately NOT reverted: only the learning rate changes.

The model is a torch module: `TrainState.params` holds its live parameters
by name, `best_params` a CPU copy. A step runs the loss, its backward and
train/optim.py's update (optax's arithmetic) in place.
"""

from collections.abc import Callable
from dataclasses import dataclass, field
from typing import Any

import torch

from speech_recognition_tools_tpu_torch.train.optim import f32, make_optimizer


@dataclass
class TrainConfig:
    optimizer: str = "adam"
    learning_rate: float = 1e-3
    epochs: int = 20
    lrr: float = 0.5  # LR reduction rate on dev regression
    lr_tol: float = 0.0  # relative tolerance before reducing
    clip_threshold: float | None = 1.0
    min_lr: float = 1e-8
    seed: int = 0


@dataclass
class TrainState:
    params: dict  # name -> the model's live parameter
    opt_state: Any
    lr: float
    epoch: int = 0
    best_params: dict | None = None  # name -> CPU copy
    best_dev_loss: float = float("inf")
    history: list = field(default_factory=list)


def host_copy(params: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in params.items()}


class Trainer:
    """Drives (train_iter, dev_iter) through the step with the LR-revert
    schedule.

    Args:
      model: the torch module whose parameters are trained.
      loss_fn: (model, batch, train: bool) -> (loss, aux_dict); `batch` is
        whatever the iterators yield. It sets the module's mode itself
        (train(train) where the loss draws dropout), as the JAX loss
        decides `deterministic` from its `train` argument.
      config: TrainConfig.
    """

    def __init__(self, model: torch.nn.Module, loss_fn: Callable,
                 config: TrainConfig = TrainConfig()):
        self.model = model
        self.loss_fn = loss_fn
        self.config = config
        self.opt = make_optimizer(config.optimizer, config.learning_rate,
                                  config.clip_threshold)

    def init_state(self) -> TrainState:
        params = dict(self.model.named_parameters())
        return TrainState(
            params=params,
            opt_state=self.opt.init(params),
            lr=self.config.learning_rate,
            best_params=host_copy(params),
        )

    def train_step(self, state: TrainState, batch):
        """One update in place; returns (loss, aux, grad norm)."""
        for p in state.params.values():
            p.grad = None
        loss, aux = self.loss_fn(self.model, batch, True)
        loss.backward()
        grads = {k: p.grad for k, p in state.params.items()}
        state.opt_state, gnorm = self.opt.apply(state.params, grads, state.opt_state)
        return loss.detach(), aux, gnorm

    def run_epoch(self, state: TrainState, train_iter):
        losses, auxes = [], []
        for batch in train_iter:
            loss, aux, _ = self.train_step(state, batch)
            losses.append(loss)
            auxes.append(aux)
        mean_loss = torch.stack(losses).mean().item() if losses else 0.0
        return mean_loss, auxes

    @torch.no_grad()
    def evaluate(self, state: TrainState, dev_iter):
        losses, auxes = [], []
        for batch in dev_iter:
            loss, aux = self.loss_fn(self.model, batch, False)
            losses.append(loss)
            auxes.append(aux)
        return (torch.stack(losses).mean().item() if losses else 0.0), auxes

    def fit(
        self,
        state: TrainState,
        make_train_iter: Callable[[], Any],
        make_dev_iter: Callable[[], Any],
        *,
        log_fn: Callable[[str], None] = print,
        checkpoint_fn: Callable[[TrainState], None] | None = None,
    ) -> TrainState:
        cfg = self.config
        torch.manual_seed(cfg.seed)  # dropout draws of losses that use them
        while state.epoch < cfg.epochs:
            tr_loss, _ = self.run_epoch(state, make_train_iter())
            dev_loss, _ = self.evaluate(state, make_dev_iter())
            state.epoch += 1
            state.history.append(
                {"epoch": state.epoch, "train_loss": tr_loss,
                 "dev_loss": dev_loss, "lr": state.lr}
            )
            # LR-halve-and-revert (reference :248-262)
            if dev_loss > state.best_dev_loss * (1.0 + cfg.lr_tol):
                state.lr = max(state.lr * cfg.lrr, cfg.min_lr)
                with torch.no_grad():
                    for k, p in state.params.items():
                        p.copy_(state.best_params[k])
                state.opt_state["learning_rate"] = f32(state.lr)
                log_fn(
                    f"epoch {state.epoch}: dev regressed "
                    f"({dev_loss:.5f} > {state.best_dev_loss:.5f}); "
                    f"lr -> {state.lr:.2e}, weights reverted"
                )
            else:
                state.best_dev_loss = dev_loss
                state.best_params = host_copy(state.params)
                log_fn(
                    f"epoch {state.epoch}: train {tr_loss:.5f} "
                    f"dev {dev_loss:.5f} lr {state.lr:.2e}"
                )
            if checkpoint_fn is not None:
                checkpoint_fn(state)
        return state
