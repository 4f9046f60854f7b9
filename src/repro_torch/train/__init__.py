"""Training for the LM stack (the counterpart of ``repro.train``): AdamW
with its schedule and clipping, the train step with micro-batching,
checkpoints on the JAX package's layout, int8 gradient compression and
restart / straggler utilities."""

from repro_torch.train.optimizer import OptConfig, apply_gradients, init_opt_state, lr_at
from repro_torch.train.train_step import make_train_step, make_eval_step
from repro_torch.train import checkpoint, compression, resilience

__all__ = [
    "OptConfig", "apply_gradients", "init_opt_state", "lr_at",
    "make_train_step", "make_eval_step", "checkpoint", "compression",
    "resilience",
]
