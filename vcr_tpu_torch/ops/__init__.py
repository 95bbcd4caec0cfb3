"""Hand-written CUDA kernels, each beside its plain PyTorch version, and
the custom ops that carry them (``library``, registered on import)."""

from vcr_tpu_torch.ops import library  # noqa: F401
