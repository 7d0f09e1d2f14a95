"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

Everything that measures, generates traffic, computes reference answers or
reduces traces lives here; from the port it takes only the system under
test and its spans, counters and kernel names. ``run.py`` is the entry.
"""
