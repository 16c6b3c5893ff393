"""Dataclass configs, framework-free: copies of ``UNetConfig``,
``ClassifierConfig``, ``TrainConfig`` and ``EvalConfig`` from
``adipose_tpu/core/config.py``.

``from_json`` ignores keys it does not know, so a config written by the JAX
package loads here.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from pathlib import Path


class _JsonMixin:
    def to_json(self, path: str | Path | None = None) -> str:
        text = json.dumps(dataclasses.asdict(self), indent=2, default=str)
        if path is not None:
            Path(path).write_text(text)
        return text

    @classmethod
    def from_json(cls, path: str | Path):
        data = json.loads(Path(path).read_text())
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in names})


@dataclass
class UNetConfig(_JsonMixin):
    """Architecture of the dilated-bottleneck U-Net: 3-level encoder from
    ``init_nb`` filters, six summed dilated convs, skip-concat decoder,
    two-class softmax head, optional deep-supervision heads."""

    tile_size: int = 1024
    init_nb: int = 44
    dropout_rate: float = 0.3
    use_deep_supervision: bool = False
    dilation_rates: tuple = (1, 2, 4, 8, 16, 32)
    compute_dtype: str = "bfloat16"  # params stay float32
    # Rematerialization of every stage / of the level-1 stages: the JAX
    # package's knobs; the port's trainer raises "not ported yet" on either.
    remat: bool = False
    remat_level1: bool = False
    # The sigmoid(logit difference) head through the head kernel and its
    # backward. Off for training as in the JAX package; inference paths
    # build the model directly with it on.
    fast_head: bool = False


@dataclass
class ClassifierConfig(_JsonMixin):
    """InceptionV3 + GAP/Dropout/Dense-sigmoid head
    (``Classification/train_adipose_classifier_v0.py:312-319``)."""

    image_size: int = 299
    dropout_rate: float = 0.4
    unfreeze_from: str = "mixed7"  # phase-2 unfreeze point (:493-503)
    compute_dtype: str = "bfloat16"


@dataclass
class TrainConfig(_JsonMixin):
    """Two-phase fine-tuning envelope (``train_adipose_unet_v3.py:1316-1421``)."""

    batch_size: int = 2
    epochs_phase1: int = 50
    epochs_phase2: int = 100
    lr_phase1: float = 1e-4
    lr_phase2: float = 1e-5
    optimizer: str = "adam"  # 'adam' | 'adamw'
    weight_decay: float = 0.01
    # Loss selection (compile_model matrix, :780-879)
    use_hard_mining: bool = False
    ohem_ratio: float = 0.7
    use_label_smoothing: bool = False
    epsilon_pos: float = 0.03
    epsilon_neg: float = 0.07
    ds_weight_main: float = 1.0
    ds_weight_aux1: float = 0.4
    ds_weight_aux2: float = 0.3
    # EMA (EMACallback :410-505)
    use_ema: bool = False
    ema_decay_phase1: float = 0.999
    ema_decay_phase2: float = 0.995
    # Schedule (CosineAnnealingWithWarmup :368-407)
    use_cosine_schedule: bool = False
    warmup_epochs: int = 5  # phase 1 (--warmup-epochs-phase1)
    warmup_epochs_phase2: int = 3  # (--warmup-epochs-phase2)
    min_lr: float = 1e-7
    # Data
    augment_level: str = "moderate"  # light|moderate|heavy|tta_style
    normalization_method: str = "zscore"  # zscore | percentile
    percentile_low: float = 1.0
    percentile_high: float = 99.0
    # RAM tile-cache budget per dataset, megabytes; 0 disables caching.
    cache_limit_mb: int = 4096
    # Early stopping
    early_stopping_patience: int = 15
    # Mesh: more than one device and spatial sharding are not ported yet.
    num_devices: int = 0  # 0 = all available
    shard_spatial: bool = False
    seed: int = 865


@dataclass
class EvalConfig(_JsonMixin):
    """Publication evaluation options (``full_evaluation_enhanced.py:1961+``)."""

    use_tta: bool = False
    tta_mode: str = "basic"  # minimal|basic|full
    use_sliding_window: bool = False
    sliding_overlap: float = 0.5
    blend_mode: str = "gaussian"  # gaussian|linear|none
    use_boundary_refinement: bool = False
    refine_kernel: int = 5  # --refine-kernel (:1452)
    threshold: float = 0.5
    optimize_threshold: bool = True
    adaptive_threshold: bool = False  # two-stage 0.1-0.9 grid (:891-939)
    n_bootstrap: int = 10000
    eval_seed: int = 1337  # set_deterministic_seeds (:647-655)
    use_ema_weights: bool = False
    # The device batch: TTA views fold into it, so the evaluator divides the
    # tile chunk by the view count.
    batch_size: int = 16
    # Prediction download precision: 'float16' halves the device-to-host
    # copy at <= 5e-4 quantization error; 'float32' copies exactly.
    transfer_dtype: str = "float16"
    # Dice-bucketed overlay dumps over a sampled pos/neg tile subset
    # (--save-overlays/--n-positive/--n-negative, :1111-1140, :1801-1876)
    save_overlays: bool = False
    n_positive: int = 120
    n_negative: int = 30
