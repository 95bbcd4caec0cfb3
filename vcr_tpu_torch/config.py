"""Typed configuration: the counterpart of ``vcr_tpu/config.py``.

``Config`` has every field of the JAX package's, with the same names and
defaults, so the same command line parses to the same values and a
checkpoint's embedded config round-trips through ``to_dict``/``from_dict``.
What the port does with each field:

* most fields mean what they mean in the JAX package;
* :data:`INERT_FIELDS` are accepted and do nothing here (see there);
* the values of features not ported yet raise ``NotImplementedError``
  naming their ROADMAP item (:meth:`Config.validate`): ``mesh_*`` away from
  1 in a mode other than the train modes (the sharded pool and the
  multi-device artifact, A15b). An unknown architecture raises there too, before
  any data is read, and so does ``--mode train_rationale`` or
  ``train_spatial`` with an ``--arch`` other than S2VT or S2VT-att, which
  the JAX package would quietly replace by S2VT; an unknown serving mode
  (``serve_kv_cache`` other than bf16/int8/int4, ``serve_decode_weights``
  other than bf16/int8) raises ValueError.

The device is not a field: the command line's ``--device`` (:func:`get_config`)
chooses it, so it never lands in a checkpoint's embedded config.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

from vcr_tpu_torch.models import base as model_base

CORPORA = ("msvd", "msrvtt", "msvd_vgg")
# the modes that take --mesh_dp / --mesh_mp (multi-process training)
TRAIN_MODES = ("train", "train_rationale", "train_spatial")
ARCHS = ("s2vt", "s2vt-att", "transformer")

# Fields that steer the JAX package's compiler and have no meaning on the
# card. They are parsed and kept (a checkpoint written by either package
# carries them), and nothing reads them:
#   use_pallas        -- CUDA tensors always take the hand-written kernels;
#   rng_impl          -- JAX's PRNG implementation; the port seeds
#                        torch.Generators with ints;
#   compile_cache_dir -- XLA's persistent compilation cache; the kernels
#                        are built once per source hash
#                        (vcr_tpu_torch/ops/_build.py).
INERT_FIELDS = ("use_pallas", "rng_impl", "compile_cache_dir")


@dataclass
class Config:
    """All knobs. Field names follow the reference flags where they exist."""

    # General
    mode: str = "train"

    # Data
    data_dir: str = "./data"
    corpus: str = "msvd_vgg"
    nworkers: int = 4
    bsize: int = 32
    shuffle: bool = True
    glove_emb_file: str = "glove.6B.300d.txt"

    # Image model (the featurizers and the prep modes)
    img_size: int = 224
    vision_arch: str = "resnet34"
    num_frames: int = 30
    vid_feat_size: int = 4096

    # Model
    arch: str = "s2vt"
    max_len: int = 20
    dropout_p: float = 0.2
    hidden_size: int = 512
    schedule_sample: bool = False
    tau: float = 1.0
    pretrained_base: Optional[str] = None

    # Transformer shape
    tf_layers: int = 6
    tf_heads: int = 8

    # Optimization
    optim: str = "adam"
    lr: float = 2e-3
    wd: float = 4e-5
    momentum: float = 0.9
    epochs: int = 1000
    max_norm: float = 1.0
    start_epoch: int = 0
    lambda_brev: float = 1.0
    lambda_cont: float = 1.0

    # Other
    save_path: str = "./trained_models"
    log_dir: str = "./logs"
    log_iter: int = 5
    n_sample_sent: int = 5
    resume: bool = False
    seed: int = 123

    # Mesh axes, data-parallel x model-parallel: the train modes only
    mesh_dp: int = 1
    mesh_mp: int = 1
    # Compute dtype of the products ("bfloat16" or "float32"); parameters
    # and recurrent state stay float32.
    compute_dtype: str = "bfloat16"
    use_pallas: bool = False          # inert (INERT_FIELDS)
    # Pad the vocab axis to a multiple of this; 1 = exact reference widths.
    vocab_pad_to: int = 1
    # Recompute the train forward in the backward instead of keeping it.
    remat: bool = False
    # Split each batch into this many microbatches and make one update from
    # their valid-row-weighted gradients: the full-batch gradient.
    grad_accum: int = 1
    compile_cache_dir: str = ""       # inert (INERT_FIELDS)
    rng_impl: str = "rbg"             # inert (INERT_FIELDS)
    # Beam width of validation and --mode decode (1 = greedy).
    beam_size: int = 1
    # --mode decode: temperature > 0 samples instead (optionally top-k and/or
    # top-p restricted). 0 = off.
    sample_temperature: float = 0.0
    sample_top_k: int = 0
    sample_top_p: float = 0.0
    # Save a mid-epoch checkpoint every N train iterations (0 = off).
    ckpt_iter: int = 0
    # --mode serve: the HTTP daemon over a continuous-batching slot pool.
    # serve_slots = R decode slots, serve_admit_chunk = A videos encoded per
    # admission, serve_port 0 = OS-assigned; serve_max_pending -1 = 4 *
    # serve_slots; serve_models "name=path,..." serves several checkpoints
    # from one port. serve_kv_cache int8/int4 quantizes the Transformer's
    # K/V caches, serve_decode_weights int8 every family's decode weights
    # (serving_continuous.ContinuousCaptioner).
    serve_port: int = 8000
    serve_slots: int = 64
    serve_admit_chunk: int = 8
    serve_max_pending: int = -1
    serve_timeout_s: float = 120.0
    serve_request_sampling: bool = False
    serve_kv_cache: str = "bf16"
    serve_decode_weights: str = "bf16"
    serve_profile_dir: str = ""
    serve_models: str = ""
    serve_auth_token: str = ""
    serve_max_body_mb: float = 256.0
    # METEOR matcher-stage resources (evals/metrics.py): "" = off; synonyms
    # "wordnet" has no table here (the stage stays inert, with a warning),
    # else a `word<TAB>synset ids` TSV path; paraphrases a
    # `phrase<TAB>phrase` TSV path.
    meteor_synonyms: str = ""
    meteor_paraphrases: str = ""
    # eval_attention export inputs
    spatial_net_file: str = ""
    vid_file: str = ""
    out_dir: str = "./attention_maps"
    export_all: bool = False

    def validate(self) -> "Config":
        if self.corpus not in CORPORA:
            raise NotImplementedError(f"Unknown corpus {self.corpus!r}")
        if self.arch not in ARCHS:
            raise NotImplementedError(f"Unknown model architecture {self.arch!r}")
        model_base.build_model(self.arch)  # raises for an unknown family
        if self.mode in ("train_rationale", "train_spatial") and self.arch not in (
                "s2vt", "s2vt-att"):
            # the JAX package trains these over S2VT where --arch names another
            # family; this package refuses instead of ignoring the flag
            raise NotImplementedError(
                f"--mode {self.mode} wraps S2VT or S2VT-att, not --arch {self.arch}")
        for name in ("mesh_dp", "mesh_mp"):
            value = getattr(self, name)
            if value < 1:
                raise ValueError(f"--{name} must be >= 1, got {value}")
            if value > 1 and self.mode not in TRAIN_MODES:
                raise NotImplementedError(
                    f"--{name} {value} with --mode {self.mode}: multi-device serving "
                    "and artifacts are not ported yet: ROADMAP A15b (the train modes "
                    "take a mesh)")
        model_base.check_serving_modes(self.serve_kv_cache, self.serve_decode_weights)
        return self

    # ---- serialization (checkpoints embed the config) ----
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls.from_dict(json.loads(s))

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)


# I/O and runtime knobs that stay under command-line control when a
# checkpoint's embedded config is adopted; everything else (arch, widths,
# dtype, tau, ...) comes from the checkpoint, so the rebuilt model matches the
# stored weights.
_CLI_OVERRIDE_FIELDS = (
    "data_dir", "corpus", "glove_emb_file", "save_path", "bsize", "nworkers",
    "n_sample_sent", "beam_size", "sample_temperature", "sample_top_k",
    "sample_top_p",
    "seed", "out_dir", "vid_file", "export_all",
    "pretrained_base", "spatial_net_file", "log_dir", "log_iter",
    "mesh_dp", "mesh_mp", "compile_cache_dir",
    "serve_port", "serve_slots", "serve_admit_chunk",
    "serve_max_pending", "serve_timeout_s", "serve_request_sampling",
    "serve_kv_cache", "serve_decode_weights",
    "serve_profile_dir", "serve_models", "serve_auth_token",
    "serve_max_body_mb",
    "meteor_synonyms", "meteor_paraphrases",
)


def adopt_checkpoint_config(cli_cfg: Config, meta: Dict[str, Any]) -> Config:
    """The Config of an eval/decode-style consumer of a checkpoint: model
    hyperparameters from the checkpoint's embedded config, I/O and runtime
    knobs from the command line."""
    cfg = Config.from_dict(meta["config"])
    return cfg.replace(**{f: getattr(cli_cfg, f) for f in _CLI_OVERRIDE_FIELDS})


def _str2bool(t: str) -> bool:
    # anything not in the truthy set is False, as the reference's flags
    return t.lower() in ("true", "t", "1")


DEVICES = ("cuda", "cpu")


def build_parser() -> argparse.ArgumentParser:
    """One flag per Config field, plus ``--device``."""
    p = argparse.ArgumentParser(
        description="vcr_tpu_torch: video captioning with rationales, PyTorch on CUDA")
    for f in dataclasses.fields(Config):
        name = "--" + f.name
        default = f.default
        if f.type in ("bool", bool) or isinstance(default, bool):
            p.add_argument(name, default=default, type=_str2bool)
        elif isinstance(default, int):
            p.add_argument(name, default=default, type=int)
        elif isinstance(default, float):
            p.add_argument(name, default=default, type=float)
        else:
            p.add_argument(name, default=default, type=str)
    p.add_argument("--device", default="cuda", choices=DEVICES,
                   help="where the model runs: the card (default; raises without "
                        "one) or the CPU, through the kernels' plain versions")
    return p


def get_config(argv: Optional[list] = None) -> Tuple[Config, str]:
    """-> (validated Config, device) from the command line."""
    ns = vars(build_parser().parse_args(argv))
    device = ns.pop("device")
    cfg = Config(**ns).validate()
    print(f"Running on {cfg.corpus.upper()} corpus")
    return cfg, device
