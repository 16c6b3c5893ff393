"""Dataclass configs, framework-free: copies of ``UNetConfig``,
``ClassifierConfig``, ``TrainConfig``, ``EvalConfig``, ``DataBuildConfig``,
``WSIChunkConfig`` and ``ECMPreprocessConfig`` from ``adipose_tpu/core/config.py``.

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
    # package's regions, recomputed in the backward (torch.utils.checkpoint).
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
    # Devices, one process each (the CLI or torchrun starts them), and
    # spatial sharding of each tile's rows over the devices the batch
    # leaves idle (the make_mesh_spatial plan).
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


@dataclass
class DataBuildConfig(_JsonMixin):
    """Dataset-build DEFAULTS (``Segmentation/build_dataset.py:159-198``). The
    same fields and defaults as the JAX package's, so ``build_log.json``'s
    ``config`` block is the same; the device is the builder's argument."""

    tile_size: int = 1024
    stride: int = 1024
    min_confidence_train: int = 1
    min_confidence_eval: int = 2  # reference name: min_confidence_val
    white_threshold: int = 235
    white_ratio: float = 0.70
    blur_threshold: float = 7.5  # Laplacian variance (classify_tiles_batch :1253)
    ambiguous_low: float = 0.0
    ambiguous_high: float = 0.05  # 0<ratio<min_mask_ratio tiles excluded (:1571)
    negative_fraction: float = 0.40  # negatives resampled to 40% (:1589-1632)
    val_fraction: float = 0.20  # DEFAULTS table :175
    test_fraction: float = 0.0  # internal test off; external test/ dir instead
    apply_stain_norm: bool = False
    seed: int = 865
    # Classification-dataset extras (build_class_dataset.py)
    adipose_coverage_threshold: float = 0.025  # >=2.5% mask coverage => adipose (:683-690)
    channel: str = "pseudocolored"  # 'ecm' | 'pseudocolored' (:183-204)
    balance_classes: bool = True  # --balance-classes/--no-balance (:151-154)
    # Mask building (DEFAULTS :159-198)
    make_masks: bool = True
    make_overlays: bool = False
    target_mask: str = "fat"  # CLASS_NAMES = bubbles|fat|muscle (:152)
    subtract: bool = True
    subtract_class: str = "bubbles"
    subtract_masks_dir: str | None = None
    morph_close_k: int = 0  # 0 disables (:166)
    min_cc_px: int = 0  # 0 disables (:167)
    # Tile IO / handling
    jpeg_quality: int = 100
    invert_input: bool = False
    keep_white: bool = True  # QA-route, don't discard (:182-183; dataset
    keep_blurry: bool = True  # membership needs 'tissue' either way, :1536-1546)
    compression: str = "auto"  # TIFF: auto|lzw|packbits|none
    workers: int | None = None  # mask rasterization parallelism (None = cpu-1)
    # Split / discovery
    split_by_slide: bool = True
    include_test_set: bool = False  # pick up Pseudocolored/test/ (:186)
    exclude_test_duplicates: bool = True
    reference_path: str | None = None  # stain reference image
    reference_metadata: str | None = None  # stain reference metadata JSON
    # Test-split-specific knobs (:191-197)
    test_min_mask_ratio: float = 0.0
    test_stride: int = 1024
    test_neg_pct: float = 1.0
    test_min_confidence: int = 2
    test_include_white: bool = False
    test_include_blurry: bool = False
    include_ambiguous: bool = False  # test-only: ambiguous kept as zero-mask negatives
    # Classification-build QC semantics (build_class_dataset.py:692-702):
    # quality filters apply only to NEGATIVES (positives always kept) and
    # kept white/blurry tiles stay IN the dataset instead of QA-routing
    protect_positives: bool = False


@dataclass
class WSIChunkConfig(_JsonMixin):
    """WSI chunkers (``pre-post-processing_tools/large_wsi_to_small_wsi_MS.py`` /
    ``..._Lucy.py``)."""

    # MS adaptive chunker
    primary_tile: int = 6144
    edge_multiple: int = 1024
    max_chunk_mb: float = 50.0
    # Lucy grid chunker
    grid_tile: int = 2048
    grid_overlap: int = 204  # stride 1844
    convert_16to8: bool = True
    invert: bool = False
    enhancement: str = "none"  # none|zscore|percentile|clahe
    # Directory-driver knobs (..._MS.py:642-671)
    max_dimension_px: int = 13112
    min_dimension_px: int = 13112
    output_format: str = "auto"  # auto|jpg|png|tiff
    bit_depth: str = "auto"  # auto|8|16
    save_enhanced: bool = False  # also write enhanced/ variants


@dataclass
class ECMPreprocessConfig(_JsonMixin):
    """ECM fluorescence-channel cleanup
    (``pre-post-processing_tools/preprocess_small_MS_SIMs.py``)."""

    # stage 1: banding removal (defaults mirror the reference argparse,
    # preprocess_small_MS_SIMs.py:853-878)
    deband_method: str = "none"  # fft|morphological|column_norm|none
    fft_freq_low: float = 0.01
    fft_freq_high: float = 0.05
    fft_width: int = 3
    fft_sigma_scale: float = 0.5
    fft_blend: float = 1.0
    morph_width: int = 1
    morph_height: int = 512
    column_preserve_global: bool = True
    # stage 2: normalization (:881-889)
    normalization_method: str = "none"  # percentile|zscore|none
    percentile_low: float = 1.0
    percentile_high: float = 99.0
    # stage 3: illumination correction (:892-914)
    illumination_method: str = "none"  # rolling_ball|gaussian|tophat|clahe|none
    rolling_ball_radius: int = 100
    poly_sigma: float = 150.0
    tophat_kernel: int = 301
    clahe_illum_tile: int = 16
    clahe_illum_clip: float = 2.0
    # stage 4: contrast CLAHE (:917-923)
    apply_clahe: bool = False
    clahe_clip: float = 3.0
    clahe_grid: int = 16
    # stage 5: unsharp sharpening (:926-932)
    sharpen: bool = False
    sharpen_sigma: float = 1.0
    sharpen_amount: float = 0.5
