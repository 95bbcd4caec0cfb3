"""Command line: ``python -m vcr_tpu_torch.cli --mode train | train_rationale
| train_spatial | eval | decode | serve | verify_parity | export_reference
| export_serving | export_continuous [--flags]``, the counterpart of
``vcr_tpu/cli.py``.

Every flag of the JAX package's command line parses to the same Config;
``--device cuda`` (the default, which raises without a card) or ``--device
cpu`` chooses where the model runs. The JAX package's other modes raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import os
import random
import sys

import numpy as np

from vcr_tpu_torch.config import Config, get_config

# modes of the JAX package's command line that this package has not ported
NOT_PORTED_MODES = {
    "extract_captions": "ROADMAP A17 (featurizers and prep)",
    "extract_video_feats": "ROADMAP A17 (featurizers and prep)",
    "extract_bbox_feats": "ROADMAP A17 (featurizers and prep)",
    "extract_glove": "ROADMAP A17 (featurizers and prep)",
    "eval_attention": "ROADMAP A17 (featurizers and prep)",
    "bench": "ROADMAP A4 (the port's benchmark)",
}


def set_random_seeds(seed: int) -> None:
    """Seed the host-side RNGs; the model's draws come from generators seeded
    explicitly from the same seed."""
    random.seed(seed)
    np.random.seed(seed)


def main(argv=None):
    """Parse ``argv`` and run its mode; returns what the mode returns (the
    validation metrics of train and eval, the captions of decode)."""
    cfg, device = get_config(argv)
    set_random_seeds(cfg.seed)
    if cfg.meteor_synonyms or cfg.meteor_paraphrases:
        from vcr_tpu_torch.evals.metrics import configure_meteor_resources

        summary = configure_meteor_resources(cfg.meteor_synonyms, cfg.meteor_paraphrases)
        if summary:
            print(summary)
    return dispatch(cfg, device)


def dispatch(cfg: Config, device=None):
    if cfg.mode in NOT_PORTED_MODES:
        raise NotImplementedError(
            f"--mode {cfg.mode} is not ported yet: {NOT_PORTED_MODES[cfg.mode]}")
    if cfg.mode in ("train", "train_rationale", "train_spatial"):
        from vcr_tpu_torch.train.loop import train

        return train(cfg, device)
    if cfg.mode == "eval":
        from vcr_tpu_torch.train.loop import evaluate_checkpoint

        return evaluate_checkpoint(cfg, cfg.pretrained_base or "", device)
    if cfg.mode == "decode":
        from vcr_tpu_torch.tools import decode_corpus

        out = os.path.join(cfg.save_path, "captions.json")
        results = decode_corpus(cfg, cfg.pretrained_base or "", out,
                                beam_size=cfg.beam_size, device=device)
        print(f"captions written to {out}")
        return results
    if cfg.mode == "serve":
        from vcr_tpu_torch.tools import serve_captions

        return serve_captions(cfg, cfg.pretrained_base or "", device=device)
    if cfg.mode == "export_reference":
        from vcr_tpu_torch.tools import export_reference_checkpoint

        out = export_reference_checkpoint(cfg, cfg.pretrained_base or "")
        print(f"reference-format checkpoint written to {out}")
        return out
    if cfg.mode == "export_serving":
        from vcr_tpu_torch.tools import export_serving_artifact

        out = export_serving_artifact(cfg, cfg.pretrained_base or "", device=device)
        print(f"serving artifact written to {out}")
        return out
    if cfg.mode == "export_continuous":
        from vcr_tpu_torch.tools import export_continuous_artifact

        out = export_continuous_artifact(cfg, cfg.pretrained_base or "", device=device)
        print(f"continuous-serving artifact written to {out}")
        return out
    if cfg.mode == "verify_parity":
        from vcr_tpu_torch.tools import verify_parity

        # pretrained_base carries the reference .net path for this mode
        if not cfg.pretrained_base:
            raise SystemExit("--mode verify_parity needs --pretrained_base "
                             "<reference model_*.net> (the checkpoint to convert)")
        out = os.path.join(cfg.save_path, "parity.json")
        results = verify_parity(cfg, cfg.pretrained_base, out, device=device)
        print(f"parity decode written to {out}")
        return results
    raise NotImplementedError("unrecognized mode")


if __name__ == "__main__":
    main(sys.argv[1:])
