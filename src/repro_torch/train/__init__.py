from .optimizer import AdamWConfig, OptState
from .step import (TrainHyper, init_state, make_grad_fn, make_loss_fn,
                   make_prefill_step, make_serve_step, make_train_step)

__all__ = ["AdamWConfig", "OptState", "TrainHyper", "init_state",
           "make_grad_fn", "make_loss_fn", "make_prefill_step",
           "make_serve_step", "make_train_step"]
