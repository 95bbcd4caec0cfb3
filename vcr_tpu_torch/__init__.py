"""vcr_tpu_torch: the video captioner in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper.

A second implementation beside the JAX package ``vcr_tpu``, which stays the
reference. Parameters keep that package's ``(in, out)`` layout and key names,
so one set of weights drives both (``vcr_tpu_torch.bridge``). This package
imports torch and numpy only.

It serves and trains the JAX package's five captioners: the flagship
S2VT, S2VT-att, the Transformer, and RationaleNet and SpatialNet over S2VT
or S2VT-att (``serving``, ``train.step``), also from the command line
``python -m vcr_tpu_torch.cli --mode train | train_rationale |
train_spatial | eval | decode | serve | verify_parity | export_reference
| export_serving | export_continuous`` (the loop, checkpoints, beam search,
sampling, the caption metrics, the reference's ``.net`` files and the
deployable artifacts). ``--mode serve`` runs an HTTP daemon (``server``,
``multiserver``; ``client`` talks to it) over a continuous-batching slot
pool (``serving_continuous``), live or frozen. The artifacts
(``export_serving``: ``export_captioner``, ``load_artifact``;
``export_continuous``: ``export_continuous``, ``load_continuous``) are
``torch.export`` programs that a serving host runs with torch, numpy and
the op library (``ops.library``) alone. Entry points run on ``cuda``
unless the caller passes ``device="cpu"``. A CUDA tensor goes through the hand-written
kernel; the plain PyTorch version of each kernel serves CPU tensors only.
The kernels on the training path (B1, B2) take their gradients through
``torch.autograd.Function``s whose backward recomputes the plain recurrence,
as the JAX package's ``custom_vjp`` does.
"""

__version__ = "0.1.0"


def __getattr__(name):
    # the artifact entry points, imported on first use (as in vcr_tpu)
    if name in ("export_captioner", "load_artifact"):
        from vcr_tpu_torch.export_serving import export_captioner, load_artifact
        return {"export_captioner": export_captioner, "load_artifact": load_artifact}[name]
    if name == "load_continuous":
        from vcr_tpu_torch.export_continuous import load_continuous
        return load_continuous
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
