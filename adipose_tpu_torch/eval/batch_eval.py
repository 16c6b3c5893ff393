"""Evaluation-config naming (``adipose_tpu/eval/batch_eval.py``).

Only :func:`build_eval_config_string` is ported: the evaluator's output
directory is named with it. The batch evaluation of every checkpoint
(``evaluate-checkpoints``) is not ported yet (ROADMAP Queue 1).
"""

from __future__ import annotations

from adipose_tpu_torch.core.config import EvalConfig


def build_eval_config_string(cfg: EvalConfig) -> str:
    """Flag-suffix encoding shared by the evaluator's output dirs and the
    metrics visualizer (``visualize_checkpoint_metrics.py:646``)."""
    parts = []
    if cfg.use_ema_weights:
        parts.append("ema")
    if cfg.use_tta:
        parts.append(f"tta_{cfg.tta_mode}")
    if cfg.use_sliding_window:
        sw = f"sw_{cfg.blend_mode}"
        if cfg.sliding_overlap != 0.5:
            sw += f"_o{int(cfg.sliding_overlap * 100)}"
        parts.append(sw)
    if cfg.use_boundary_refinement:
        parts.append("refine" if cfg.refine_kernel == 5 else f"refine{cfg.refine_kernel}")
    if cfg.adaptive_threshold:
        parts.append("adaptive")
    return "_".join(parts)
