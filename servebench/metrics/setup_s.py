"""Seconds from the process's start to the first timed step: loading,
drawing and packing the weights, building the engine, the kernels' build
where the checkout has none, warming up and capturing the step graphs."""


def read(run):
    return run.setup_s
