"""Median milliseconds, over the window's train steps, of the forwards'
device time: CUDA events at the start and the end of each microbatch's
``train.forward`` span in the program, summed over the step."""
from bench import program_spans as ps


def read(ctx):
    return ps.per_step_device_ms(ctx, "train.forward")
