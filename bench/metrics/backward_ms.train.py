"""Median milliseconds, over the window's train steps, of the backwards'
device time: CUDA events at the start and the end of each microbatch's
``train.backward`` span in the program (``torch.autograd.grad`` and the
addition into the gradient sum), summed over the step."""
from bench import program_spans as ps


def read(ctx):
    return ps.per_step_device_ms(ctx, "train.backward")
