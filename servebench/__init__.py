"""servebench: the serving benchmark of the PyTorch and CUDA port.

``run.py`` is the entry; ``README.md`` says how to run a cell and how to
add one.
"""
