"""Inference functions over a model and explicit params (``adipose_tpu/train/state.py``)."""

from __future__ import annotations

import torch
from torch.func import functional_call


def make_unet_predict(model: torch.nn.Module):
    """``predict(params, images)``: the model's main output under
    ``torch.inference_mode()``, with ``params`` (a state dict on the images'
    device) in place of the module's own."""
    model.eval()

    def predict(params: dict[str, torch.Tensor], images: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            out = functional_call(model, params, (images,), strict=True)
        return out["main_out"] if isinstance(out, dict) else out

    return predict
