"""Share of the traced calls' wall in which nothing ran on the device: one
less the union of kernel and copy intervals (torch.profiler) over the wall,
in %."""
from benchmark.roofline import idle_percent


def read(ctx):
    return idle_percent(ctx["trace"])
