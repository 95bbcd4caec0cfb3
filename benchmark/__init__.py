"""The benchmark of vcr_tpu_torch, the PyTorch and CUDA port: one cell's run
(``run.py``), its files found by name (``core.py``), and the yardstick that
a change to the program cannot move: inputs from the seed, the copied
arithmetic, the trace's reduction, the plain references."""
