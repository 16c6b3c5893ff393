"""Two-phase U-Net fine-tuning (``adipose_tpu/train/trainer_unet.py``).

Behavioral spec: ``train_model`` (``train_adipose_unet_v3.py:1072-1443``):
  phase 1 - frozen encoder, lr 1e-4, EMA decay 0.999 (not saved), best-by-
            val-Dice checkpoint, early stopping (patience 15), cosine with
            warmup or ReduceLROnPlateau;
  phase 2 - all layers from the phase-1 best, lr 1e-5, EMA decay 0.995 with
            best-snapshot saving, the same callbacks; the final best-overall
            is the phase-2 best. Artifacts per
            :mod:`adipose_tpu_torch.train.checkpoint`.

Per batch, on one device and one CUDA stream: the uint8 batch is copied
from pinned host memory, augmented (:func:`make_augment_step`: u8 -> f32,
the tier's draws from the phase's generator, the D4 kernel), normalized
(z-score expression, or the percentile kernel through
``batched_percentile_unit_fast``), run forward and backward, and the
trainable params take the Keras-Adam update. Nothing in the epoch loop
reads the device: the step metrics stay on the device until the epoch's
means, so the host enqueues ahead while the device works, which is the
JAX package's 1-deep augment/step pipelining on one stream. A background
thread decodes the next batches meanwhile (:func:`prefetch_batches`).

On several devices the trainer is one rank of a ``torch.distributed``
process group, one process per device (``adipose-torch train-unet
--num-devices N`` starts them, or torchrun does). The step is the 1-rank
step of the global batch, as the JAX package's sharded program is: each
rank decodes only its rows of each global batch (:class:`BatchShard`),
draws the augmentation and the dropout masks for the global batch and keeps
its rows, all-gathers the outputs (differentiably) and the masks, computes
the global loss, Dice and validation statistics, and all-reduces its share
of the gradients (a sum) before the identical update on every rank. Rank 0
alone writes the artifacts; the epoch's logged row is rank 0's on every
rank, so plateau, early-stopping and EMA decisions agree.

``shard_spatial`` (``--shard-spatial``) lays the ranks out as the JAX
package's ``make_mesh_spatial`` plan over the tile size: the batch over
the data axis, and the devices the batch leaves idle over the model axis,
which cuts every tile's rows into slabs. Each rank decodes its data index's
rows, augments and normalizes whole tiles (a D4 transform swaps H and W),
takes its slab and runs the spatially sharded forward of
:class:`~adipose_tpu_torch.models.unet.DilatedUNet` (``spatial``), whose
outputs are whole tiles; the loss, Dice and OHEM's top-k are then the
global batch's, as above, and the gradient shares are summed over every
rank. A plan whose model axis is 1 is the data-parallel path.

``UNetConfig.remat``/``remat_level1`` recompute the JAX package's regions
in the backward (:class:`~adipose_tpu_torch.models.unet.DilatedUNet`), also
under ``shard_spatial``, where a replay repeats its halo exchanges on every
rank in the same order. The TPU compile-OOM retry ladder has no
counterpart. ``--pretrained-weights`` takes a TF ``.h5`` through
:mod:`adipose_tpu_torch.models.tf_import`, or a run's ``params.npz``.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch

from adipose_tpu_torch.core import tracing
from adipose_tpu_torch.core.config import TrainConfig, UNetConfig
from adipose_tpu_torch.core.host_copy import copy_in_pinned
from adipose_tpu_torch.core.seeding import generator_for
from adipose_tpu_torch.data.augment import augment_batch
from adipose_tpu_torch.data.loader import TileDataset, prefetch_batches
from adipose_tpu_torch.data.stats import compute_mean_std, dataset_image_paths
from adipose_tpu_torch.models.convert import flax_unet_to_torch, torch_unet_to_flax
from adipose_tpu_torch.models.unet import DilatedUNet, encoder_param_mask
from adipose_tpu_torch.ops import losses as L
from adipose_tpu_torch.ops.metrics import activation_stats
from adipose_tpu_torch.ops.normalize import batched_percentile_unit_fast
from adipose_tpu_torch.parallel.collectives import all_reduce_grads_, gather_rows
from adipose_tpu_torch.parallel.mesh import MeshPlan, build_rank_grid, make_mesh_spatial
from adipose_tpu_torch.parallel.multihost import (BatchShard, SlabShard, barrier,
                                                  broadcast_object, process_count,
                                                  process_index)
from adipose_tpu_torch.train import checkpoint as ckpt
from adipose_tpu_torch.train.ema import EmaTracker
from adipose_tpu_torch.train.schedules import (EarlyStopping, ReduceLROnPlateau,
                                               cosine_with_warmup)
from adipose_tpu_torch.train.state import TrainState, set_learning_rate, unet_loss_from_config

_to_device = copy_in_pinned  # bench_h100/entries and chip_smoke.py import this name from here


def make_augment_step(tier: str, shard: BatchShard | None = None):
    """``augment_step(generator, images_u8, masks_u8)``: the tier over a
    (B, H, W) uint8 batch, as float32 images and masks (with ``shard``: the
    batch is this rank's rows of the global batch, on the global draws)."""

    def augment_step(generator, images_u8, masks_u8):
        with tracing.span("train.augment"):
            return augment_batch(generator, images_u8.to(torch.float32),
                                 masks_u8.to(torch.float32), tier, shard)

    return augment_step


def normalize_images(images: torch.Tensor, norm_method: str, mean: torch.Tensor,
                     std: torch.Tensor, p_low: float, p_high: float) -> torch.Tensor:
    """The train and val steps' normalization: ``(x - mean) / (std + 1e-10)``
    with 0-dim float32 statistics, or the per-tile percentile stretch
    (``TileDataset`` :589-592) through the percentile kernel."""
    if norm_method == "zscore":
        return (images - mean) / (std + 1e-10)
    return batched_percentile_unit_fast(images, p_low, p_high)


def _global(out, masks, shard: BatchShard | None):
    """The global batch's outputs (a tensor or the deep-supervision dict)
    and masks from this rank's rows: an all-gather, differentiable for the
    outputs. The rows themselves without a shard, or when they are the
    whole batch."""
    if shard is None or shard.size == shard.total:
        return out, masks
    if isinstance(out, dict):
        out = {k: gather_rows(v, 0, shard.group) for k, v in out.items()}
    else:
        out = gather_rows(out, 0, shard.group)
    with torch.no_grad():
        return out, gather_rows(masks, 0, shard.group)


def _slab(model, images: torch.Tensor) -> torch.Tensor:
    """This rank's slab of whole tiles under the model's ``spatial``; the
    tiles themselves otherwise."""
    return images if model.spatial is None else model.spatial.rows(images)


def _make_fused_train_step(model, loss_fn, norm_method: str, p_low: float, p_high: float,
                           shard: BatchShard | None = None):
    """``step(state, images, masks, generator, mean, std) -> metrics``:
    normalize, forward and backward, then the optimizer update, on an
    augmented float32 batch. ``generator`` draws the dropout masks; the
    metrics are device tensors. With ``shard`` the batch is this rank's rows:
    the loss and metrics are the global batch's and the gradients are summed
    over every rank before the update. Under the model's ``spatial`` the
    forward takes the normalized tiles' slab."""

    def step(state: TrainState, images, masks, generator, mean, std):
        with tracing.span("train.step"):
            with tracing.span("train.forward", device=True):
                images = normalize_images(images.to(torch.float32), norm_method, mean, std,
                                          p_low, p_high)
                model.train()
                out = model(_slab(model, images), generator=generator)
            with tracing.span("train.loss", device=True):
                out, masks = _global(out, masks.to(torch.float32), shard)
                loss = loss_fn(masks, out)
            main = out["main_out"] if isinstance(out, dict) else out
            with tracing.span("train.backward", device=True):
                grads = torch.autograd.grad(loss, [state.params[k] for k in state.trainable],
                                            allow_unused=True)
            if shard is not None:
                all_reduce_grads_(grads)
            with tracing.span("train.optimizer", device=True):
                state.apply_gradients(grads)
            with torch.no_grad():
                return {"loss": loss.detach(), "dice_coef": L.dice_coef(masks, main.detach())}

    return step


def _make_val_step(model, loss_fn, norm_method: str, p_low: float, p_high: float,
                   shard: BatchShard | None = None):
    """``step(images_u8, masks_u8, mean, std) -> metrics``: loss, Dice and
    activation statistics of the main output, in eval mode (of the global
    batch, with ``shard``)."""

    def step(images_u8, masks_u8, mean, std):
        model.eval()
        with torch.inference_mode():
            images = normalize_images(images_u8.to(torch.float32), norm_method, mean, std,
                                      p_low, p_high)
            out, masks = _global(model(_slab(model, images)), masks_u8.to(torch.float32),
                                 shard)
            main = out["main_out"] if isinstance(out, dict) else out
            return {"loss": loss_fn(masks, out), "dice_coef": L.dice_coef(masks, main),
                    **activation_stats(main)}

    return step


def _epoch_means(metrics: list[dict], prefix: str = "") -> dict[str, float]:
    """Host means of per-step device metrics: one read per metric name."""
    return {f"{prefix}{k}": float(np.mean(torch.stack([m[k] for m in metrics]).cpu().numpy()))
            for k in metrics[0]}


def _host_copy(params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in params.items()}


def init_unet_params(model: DilatedUNet, seed: int) -> dict[str, torch.Tensor]:
    """Flax-style initialization of ``model``'s architecture from the
    ``unet.init`` generator, drawn on the host so that it does not depend on
    the device: a host state dict."""
    host = DilatedUNet(init_nb=model.init_nb, use_deep_supervision=model.use_deep_supervision,
                       dilation_rates=model.dilation_rates)
    host.init_params(generator_for("unet.init", seed))
    return {k: v.detach() for k, v in host.state_dict().items()}


class UNetTrainer:
    def __init__(
        self,
        data_root: str | Path,
        cfg: TrainConfig | None = None,
        model_cfg: UNetConfig | None = None,
        checkpoint_name: str = "adipose_sybreosin",
        build_timestamp: str | None = None,
        checkpoint_root: str | Path = "checkpoints/segmentation",
        auto_resume: bool = False,
        device: str | torch.device = "cuda",
    ):
        self.auto_resume = auto_resume
        self.cfg = cfg or TrainConfig()
        self.model_cfg = model_cfg or UNetConfig()
        self.device = torch.device(device)
        # The ranks are the process group's (one process per device); one
        # process trains the whole batch on its device.
        # The --shard-spatial plan is the JAX planner's with the ranks as
        # its devices.
        world = process_count()
        self.plan = (make_mesh_spatial(self.cfg.batch_size, world, self.model_cfg.tile_size,
                                       world) if self.cfg.shard_spatial else MeshPlan(world))
        slab = None
        if self.plan.model > 1:
            grid = build_rank_grid(self.plan)
            size = self.cfg.batch_size // self.plan.data
            self.shard = BatchShard(grid.data_index * size, size, self.cfg.batch_size,
                                    grid.data_group)
            slab = SlabShard(grid.model_index, self.plan.model, grid.model_group)
        else:
            self.shard = BatchShard.of_process(self.cfg.batch_size) if world > 1 else None
        self.is_main = process_index() == 0
        self.data_root = Path(data_root)
        self.ckpt_dir = ckpt.checkpoint_dir_for(
            checkpoint_name, broadcast_object(build_timestamp or ckpt.timestamp_now()),
            checkpoint_root)
        self.model = DilatedUNet(
            init_nb=self.model_cfg.init_nb,
            dropout_rate=self.model_cfg.dropout_rate,
            use_deep_supervision=self.model_cfg.use_deep_supervision,
            dilation_rates=tuple(self.model_cfg.dilation_rates),
            compute_dtype=(torch.bfloat16 if self.model_cfg.compute_dtype == "bfloat16"
                           else torch.float32),
            fast_head=self.model_cfg.fast_head,
            remat=self.model_cfg.remat,
            remat_level1=self.model_cfg.remat_level1,
            device=self.device,
        )
        self.model.batch_shard = self.shard
        self.model.spatial = slab
        self.loss_fn = unet_loss_from_config(self.cfg)
        self.history: list = []

        ds = self.data_root / "dataset"
        self.train_data = TileDataset(ds / "train" / "images", ds / "train" / "masks",
                                      self.cfg.batch_size, seed=self.cfg.seed,
                                      cache_limit_mb=self.cfg.cache_limit_mb)
        self.val_data = TileDataset(ds / "val" / "images", ds / "val" / "masks",
                                    self.cfg.batch_size, seed=self.cfg.seed,
                                    cache_limit_mb=self.cfg.cache_limit_mb)
        if not len(self.train_data):
            raise FileNotFoundError(f"no training tiles under {ds}")
        if not len(self.val_data):
            raise FileNotFoundError(f"no validation tiles under {ds}")

        # Global train stats -> normalization_stats.json (:1194-1207)
        self.mean, self.std = broadcast_object(
            compute_mean_std(dataset_image_paths(ds / "train" / "images")) if self.is_main
            else None)
        if self.is_main:
            ckpt.save_normalization_stats(self.ckpt_dir, self.mean, self.std,
                                          self.cfg.normalization_method)

    @property
    def rows(self) -> tuple[int, int] | None:
        """(start, size) of this rank's rows of each global batch, or None."""
        return None if self.shard is None else (self.shard.start, self.shard.size)

    # -- params ---------------------------------------------------------------

    def init_params(self) -> dict[str, torch.Tensor]:
        return init_unet_params(self.model, self.cfg.seed)

    def _load(self, params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """Copy ``params`` into the model; returns the model's own params."""
        live = dict(self.model.named_parameters())
        with torch.no_grad():
            for k, v in params.items():
                live[k].copy_(v)
        return live

    def load_pretrained(self, params: dict[str, torch.Tensor], path: str | Path):
        """By-name weight transfer with mismatch skipping
        (``train_adipose_unet_v3.py:881-916``) from a TF ``.h5`` /
        ``.weights.h5`` (through the importer; a file it cannot map is
        reported and the init kept) or a run or weights directory holding
        ``params.npz``; aux-head and shape-mismatched entries keep their
        fresh init."""
        p = Path(path)
        if p.suffix == ".h5" or p.name.endswith(".weights.h5"):
            from adipose_tpu_torch.models.tf_import import import_unet_weights

            try:
                return flax_unet_to_torch(import_unet_weights(p, torch_unet_to_flax(params)))
            except ValueError as e:
                print(f"[pretrained] TF import fell back to by-name merge: {e}")
                return params
        loaded = ckpt.load_params(ckpt.resolve_weights_path(p))
        merged = ckpt.merge_matching(torch_unet_to_flax(params), loaded)
        out = flax_unet_to_torch(merged)
        print(f"[pretrained] merged by name from {p} ({len(out)} leaves)")
        return out

    def _save(self, name: str, params: dict[str, torch.Tensor]) -> None:
        if self.is_main:
            ckpt.save_params(self.ckpt_dir, name, torch_unet_to_flax(params))

    # -- phases ---------------------------------------------------------------

    def _run_phase(self, phase: int, params, epochs: int, lr: float, min_lr: float,
                   ema_decay: float, freeze_encoder: bool, save_ema: bool,
                   augment_tier: str):
        cfg, dev = self.cfg, self.device
        live = self._load(params)
        mask = encoder_param_mask(live) if freeze_encoder else None
        state = TrainState.create(live, cfg.optimizer, lr, cfg.weight_decay, mask)
        train_step = _make_fused_train_step(self.model, self.loss_fn, cfg.normalization_method,
                                            cfg.percentile_low, cfg.percentile_high, self.shard)
        val_step = _make_val_step(self.model, self.loss_fn, cfg.normalization_method,
                                  cfg.percentile_low, cfg.percentile_high, self.shard)
        augment_step = make_augment_step(augment_tier, self.shard)
        warmup = cfg.warmup_epochs if phase == 1 else cfg.warmup_epochs_phase2
        schedule = (cosine_with_warmup(lr, min_lr, warmup, epochs)
                    if cfg.use_cosine_schedule else None)
        plateau = None if schedule else ReduceLROnPlateau(lr=lr, min_lr=min_lr)
        stopper = EarlyStopping(patience=cfg.early_stopping_patience)
        ema = EmaTracker(decay=ema_decay) if cfg.use_ema else None

        mean = torch.tensor(self.mean, dtype=torch.float32, device=dev)
        std = torch.tensor(self.std, dtype=torch.float32, device=dev)
        best_dice = -np.inf
        best_params = _host_copy(live)

        # Preemption recovery from the rolling 'latest' entry: params, the
        # phase-best snapshot, plateau LR, early-stop counters and the EMA;
        # the optimizer moments restart fresh, as in the JAX package.
        start_epoch = 0
        latest_meta = self.ckpt_dir / "latest_state.json"
        barrier()  # rank 0's writes of the last phase are done before any rank reads
        if self.auto_resume and latest_meta.exists():
            meta = json.loads(latest_meta.read_text())
            if meta.get("phase") == phase and (self.ckpt_dir / "latest").exists():
                self._load(flax_unet_to_torch(ckpt.load_params(self.ckpt_dir / "latest")))
                start_epoch = int(meta["epoch"]) + 1
                best_dice = float(meta.get("best_dice", -np.inf))
                best_path = self.ckpt_dir / f"phase{phase}_best"
                if best_dice > -np.inf:
                    if best_path.exists():
                        best_params = flax_unet_to_torch(ckpt.load_params(best_path))
                    else:
                        print(f"[resume] WARNING: recorded best_dice {best_dice:.4f} but "
                              f"{best_path.name} is missing - resetting best to -inf")
                        best_dice = -np.inf
                if plateau is not None and "plateau_lr" in meta:
                    plateau.lr = float(meta["plateau_lr"])
                    if meta.get("plateau_best") is not None:
                        plateau.best = float(meta["plateau_best"])
                        plateau.wait = int(meta.get("plateau_wait", 0))
                    set_learning_rate(state.optimizer, plateau.lr)
                if meta.get("stopper_best") is not None:
                    stopper.best = float(meta["stopper_best"])
                    stopper.best_epoch = int(meta.get("stopper_best_epoch", -1))
                    stopper.wait = int(meta.get("stopper_wait", 0))
                if ema is not None and (self.ckpt_dir / "latest_ema").exists():
                    ema.ema_params = {k: v.to(dev) for k, v in flax_unet_to_torch(
                        ckpt.load_params(self.ckpt_dir / "latest_ema")).items()}
                    if meta.get("ema_best_metric") is not None:
                        ema.best_metric = float(meta["ema_best_metric"])
                print(f"[resume] phase {phase} from epoch {start_epoch} "
                      f"(best dice {best_dice:.4f}; optimizer moments fresh)")

        logger = ckpt.CsvLogger(self.ckpt_dir / f"phase{phase}_training.log",
                                append=start_epoch > 0)
        for epoch in range(start_epoch, epochs):
            t0 = time.time()
            if schedule:
                set_learning_rate(state.optimizer, schedule(epoch))
            # one generator per epoch: the batch order and the draws of any
            # epoch are reproducible in isolation, as the JAX key schedule
            gen = generator_for(f"train.p{phase}", cfg.seed, epoch, device=dev)
            train_metrics = []
            for imgs, masks in prefetch_batches(self.train_data.epoch_batches(epoch,
                                                                              rows=self.rows)):
                aug_imgs, aug_masks = augment_step(gen, copy_in_pinned(imgs, dev),
                                                   copy_in_pinned(masks, dev))
                train_metrics.append(train_step(state, aug_imgs, aug_masks, gen, mean, std))
            val_metrics = [val_step(copy_in_pinned(imgs, dev), copy_in_pinned(masks, dev),
                                    mean, std)
                           for imgs, masks in prefetch_batches(
                               self.val_data.epoch_batches(epoch, shuffle=False,
                                                           rows=self.rows))]

            tm = _epoch_means(train_metrics)
            vm = _epoch_means(val_metrics, "val_")
            row = {**tm, **vm, "lr": schedule(epoch) if schedule else plateau.lr,
                   "epoch_time_s": time.time() - t0}
            # every rank takes rank 0's row, so every decision below agrees
            row = broadcast_object(row)
            vm = {k: row[k] for k in vm}
            if self.is_main:
                logger.log(epoch, row)
            self.history.append({"phase": phase, "epoch": epoch, **row})

            val_dice = vm["val_dice_coef"]
            params_now = {k: v.detach() for k, v in live.items()}
            if ema is not None:
                ema.update(params_now, metric=val_dice if save_ema else None)
            if val_dice > best_dice:
                best_dice = val_dice
                best_params = _host_copy(params_now)
                self._save(f"phase{phase}_best", best_params)
            if plateau is not None:
                set_learning_rate(state.optimizer, plateau.update(val_dice))
            if self.auto_resume and self.is_main:
                self._save("latest", params_now)
                if ema is not None and ema.ema_params is not None:
                    self._save("latest_ema", ema.ema_params)
                latest_meta.write_text(json.dumps({
                    "phase": phase, "epoch": epoch, "best_dice": float(best_dice),
                    "plateau_lr": plateau.lr if plateau is not None else None,
                    "plateau_best": plateau.best if plateau is not None else None,
                    "plateau_wait": plateau.wait if plateau is not None else 0,
                    "ema_best_metric": ema.best_metric if ema is not None else None,
                    "stopper_best": stopper.best,
                    "stopper_best_epoch": stopper.best_epoch,
                    "stopper_wait": stopper.wait,
                }))
            if stopper.update(val_dice, epoch):
                break

        if ema is not None and save_ema and ema.snapshot is not None:
            self._save("weights_ema", ema.snapshot)
        return best_params, best_dice

    def train(self, epochs_phase1: int | None = None, epochs_phase2: int | None = None,
              resume_from: str | Path | None = None,
              pretrained_weights: str | Path | None = None):
        """``resume_from``: a run or weights directory; phase 1 is skipped and
        phase 2 fine-tunes from those weights (``--resume-from``,
        ``train_adipose_unet_v3.py:1336-1339``). ``pretrained_weights``:
        by-name transfer into the fresh init before phase 1
        (``--pretrained-weights``, :881-916)."""
        cfg = self.cfg
        tier = cfg.augment_level
        params = self.init_params()
        if pretrained_weights:
            params = self.load_pretrained(params, pretrained_weights)
        if resume_from is not None:
            params = flax_unet_to_torch(ckpt.load_params(ckpt.resolve_weights_path(resume_from)))

        if self.is_main:
            ckpt.write_training_settings(self.ckpt_dir, {
                **vars(cfg),
                "use_deep_supervision": self.model_cfg.use_deep_supervision,
                "init_nb": self.model_cfg.init_nb,
                "tile_size": self.model_cfg.tile_size,
                "dropout_rate": self.model_cfg.dropout_rate,
                "dilation_rates": tuple(self.model_cfg.dilation_rates),
                "train_tiles": len(self.train_data),
                "val_tiles": len(self.val_data),
                "normalization_mean": self.mean,
                "normalization_std": self.std,
            })
        e1 = cfg.epochs_phase1 if epochs_phase1 is None else epochs_phase1
        e2 = cfg.epochs_phase2 if epochs_phase2 is None else epochs_phase2

        # Phase-2 preemption: saved progress already in phase 2 means phase 1
        # is done; re-running it would clobber the phase-2 rolling state.
        resumed_past_phase1 = False
        meta_path = self.ckpt_dir / "latest_state.json"
        if self.auto_resume and meta_path.exists():
            meta = json.loads(meta_path.read_text())
            if meta.get("phase") == 2 and (self.ckpt_dir / "phase1_best").exists():
                best1 = flax_unet_to_torch(ckpt.load_params(self.ckpt_dir / "phase1_best"))
                dice1 = float("nan")
                resumed_past_phase1 = True
                print("[resume] phase 1 already complete; resuming phase 2")
        if resumed_past_phase1:
            pass
        elif resume_from is not None:
            best1, dice1 = params, float("nan")
        else:
            best1, dice1 = self._run_phase(1, params, e1, cfg.lr_phase1, cfg.min_lr,
                                           cfg.ema_decay_phase1, freeze_encoder=True,
                                           save_ema=False, augment_tier=tier)
        best2, dice2 = self._run_phase(2, best1, e2, cfg.lr_phase2, cfg.min_lr * 0.1,
                                       cfg.ema_decay_phase2, freeze_encoder=False,
                                       save_ema=True, augment_tier=tier)
        self._save("weights_best_overall", best2)
        if self.is_main:
            try:
                from adipose_tpu_torch.train.plots import plot_training_history

                plot_training_history(self.ckpt_dir)
            except Exception:
                pass  # plotting is best-effort; never fail a finished run
        return {"phase1_best_dice": dice1, "phase2_best_dice": dice2,
                "checkpoint_dir": str(self.ckpt_dir)}
