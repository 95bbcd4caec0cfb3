"""vcr_tpu_torch: the video captioner in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper.

A second implementation beside the JAX package ``vcr_tpu``, which stays the
reference. Parameters keep that package's ``(in, out)`` layout and key names,
so one set of weights drives both (``vcr_tpu_torch.bridge``). This package
imports torch and numpy only.

It serves and trains the flagship S2VT and RationaleNet over it
(``serving``, ``train.step``), also from the command line ``python -m
vcr_tpu_torch.cli --mode train | train_rationale | eval | decode`` (the
loop, checkpoints, beam search, sampling and the caption metrics). Entry
points run on ``cuda`` unless the
caller passes ``device="cpu"``. A CUDA tensor goes through the hand-written
kernel; the plain PyTorch version of each kernel serves CPU tensors only.
The kernels on the training path (B1, B2) take their gradients through
``torch.autograd.Function``s whose backward recomputes the plain recurrence,
as the JAX package's ``custom_vjp`` does.
"""

__version__ = "0.1.0"
