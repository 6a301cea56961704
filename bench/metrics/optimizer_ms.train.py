"""Median milliseconds, over the window's train steps, of the optimizer's
device time: CUDA events at the start and the end of the program's
``train.optimizer`` span (the AdamW update, clipping with it)."""
from bench import program_spans as ps


def read(ctx):
    return ps.per_step_device_ms(ctx, "train.optimizer")
