"""Checkpoint -> predict for the port's two models.

A checkpoint dir holds ``params.npz`` (the Flax tree as numpy, see
:mod:`adipose_tpu_torch.train.checkpoint`); a segmenter's also holds its
normalization statistics and ``training_settings.log``. Each loader puts
the model on ``meta`` and returns a ``predict(params, tiles)`` that runs it
on the params it is given, with those params on ``device``.
"""

from __future__ import annotations

import torch

from adipose_tpu_torch.core import tracing
from adipose_tpu_torch.core.config import UNetConfig
from adipose_tpu_torch.models.convert import flax_inception_to_torch, flax_unet_to_torch
from adipose_tpu_torch.models.inception import InceptionV3Classifier
from adipose_tpu_torch.models.unet import DilatedUNet
from adipose_tpu_torch.ops.cuda.preprocess import fused_zscore_normalize
from adipose_tpu_torch.train import checkpoint as ckpt
from adipose_tpu_torch.train.state import make_unet_predict
from adipose_tpu_torch.train.trainer_classifier import _make_val_step


def load_segmenter(weights, use_ema: bool = False, device="cuda",
                   model_cfg: UNetConfig | None = None):
    """``(predict, params, mean, std)`` for a checkpoint dir: ``predict(params,
    tiles)`` z-scores (B, H, W) uint8/float32 tiles on ``device`` with the
    checkpoint's statistics and returns (B, H, W) float32 probabilities.
    ``model_cfg`` defaults to the checkpoint's detected config."""
    weights_path = ckpt.resolve_weights_path(weights, use_ema)
    ckpt_dir = weights_path.parent
    mean, std = ckpt.load_normalization_stats(ckpt_dir)
    mcfg = model_cfg or ckpt.detect_model_config(ckpt_dir)
    compute_dtype = torch.bfloat16 if mcfg.compute_dtype == "bfloat16" else torch.float32
    model = DilatedUNet(
        init_nb=mcfg.init_nb,
        dropout_rate=mcfg.dropout_rate,
        use_deep_supervision=mcfg.use_deep_supervision,
        dilation_rates=tuple(mcfg.dilation_rates),
        compute_dtype=compute_dtype,
        device="meta",
    )
    params = {k: v.to(device) for k, v in
              flax_unet_to_torch(ckpt.load_params(weights_path)).items()}
    base = make_unet_predict(model)

    def predict(p, tiles):
        with tracing.span("model.prep"):
            x, _stats = fused_zscore_normalize(tiles, mean, std, out_dtype=compute_dtype)
        return base(p, x)

    return predict, params, mean, std


def classifier_state(weights, device="cuda") -> dict[str, torch.Tensor]:
    """The classifier state dict of a checkpoint dir, on ``device``."""
    variables = ckpt.load_params(ckpt.resolve_weights_path(weights))
    return {k: v.to(device) for k, v in flax_inception_to_torch(variables).items()}


def load_classifier(weights, device="cuda", percentile_norm: bool = True,
                    p_low: float = 1.0, p_high: float = 99.0):
    """``(predict, state)`` for a classifier checkpoint dir:
    ``predict(state, tiles)`` percentile-stretches (B, H, W) uint8/float32
    tiles on ``device`` (unless ``percentile_norm`` is off), resizes them to
    299^2 and runs the bf16 InceptionV3; it returns (B,) float32
    probabilities. (B, H, W, 3) RGB tiles are resized without channel
    tiling."""
    model = InceptionV3Classifier(compute_dtype=torch.bfloat16, device="meta")
    return (_make_val_step(model, percentile_norm, p_low, p_high),
            classifier_state(weights, device))
