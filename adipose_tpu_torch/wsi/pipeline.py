"""End-to-end dual-model WSI cascade (``adipose_tpu/wsi/pipeline.py``) on
one torch device: tile -> QC -> classify -> segment -> blend.

A slide chunk goes through these stages:

  1. one uint8 upload of the (reflect-padded) chunk, from pinned memory
     and without a host wait; each tile batch is then gathered on the
     device (:func:`~adipose_tpu_torch.ops.blend.extract_tiles`). Host
     tiling (``device_tiling=False``) gathers with numpy and uploads each
     batch instead;
  2. QC (:mod:`adipose_tpu_torch.ops.qc`) and 3. the InceptionV3 gate
     (behind the percentile kernel) on every tile, batch by batch, stacked
     into one (2, N) result whose copy to pinned host memory starts at
     once;
  4. the U-Net (z-score kernel, cuDNN convs, head kernel) on the
     classifier-positive tiles only; negative tiles leave zeros;
  5. Gaussian-blend accumulation into device-resident canvases;
  6. a striped finalize: a canvas row stripe is finalized, and its copy to
     pinned host memory starts, as soon as the last positive batch that
     reaches it has been enqueued, so the copies overlap the remaining
     segmentation;
  7. the artifacts of ``adipose pipeline`` (:meth:`run_file`, :meth:`run_files`).

Tiles reach both gates as uint8: the JAX package casts them to float32
first, which gives equal results for integer values at a quarter of the
bytes. Every device operation runs in order on the current CUDA stream;
the host waits only where it needs a value (the QC/classify result, a
finished stripe).

``group`` (a ``torch.distributed`` process group, the counterpart of the
JAX package's ``mesh``) spreads a slide's tile stream over its ranks: every
rank runs the same chunks, each QC, classify and segment batch is split
into equal shares, one a rank, and the shares' results are all-gathered,
so the verdicts, the counts and the probability map are the same on every
rank. The batch rounds up to a multiple of the ranks, tiles are cut on the
host, and the map is finalized once after the last batch (``striped``
false), as the JAX package's mesh path does.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from pathlib import Path

import cv2
import numpy as np
import torch
import torch.distributed as dist

from adipose_tpu_torch.core.host_copy import HostCopy
from adipose_tpu_torch.ops.blend import (
    accumulate_predictions,
    accumulate_weights,
    extract_tiles,
    finalize_blend_stripe,
    gaussian_weight_map,
    sliding_window_positions,
)
from adipose_tpu_torch.ops.qc import classify_tiles_batch
from adipose_tpu_torch.parallel.collectives import all_gather_tensors


@dataclass
class PipelineResult:
    probability_map: np.ndarray
    n_tiles: int
    n_good: int
    n_positive: int
    timings: dict
    # exact u8 PNG payload when transfer_dtype='uint8' (else None); already
    # quantized on the device, so writers emit it as it is
    probability_u8: np.ndarray | None = None


@dataclass
class _PendingQC:
    """Per-chunk state between :meth:`DualModelWSIPipeline._dispatch_qc`
    (QC and classification enqueued, the stacked result's copy to the host
    started) and :meth:`DualModelWSIPipeline._plan_segment` (which waits
    for it to pick the positive tiles). The split lets
    :meth:`DualModelWSIPipeline.run_many_iter` enqueue chunk k+1's QC before
    it waits for chunk k's result, so the device is not idle meanwhile."""

    gray_shape: tuple
    h: int
    w: int
    n_tiles: int
    positions: np.ndarray
    result: HostCopy                # (2, padded_n): is_good, probability
    slide_dev: torch.Tensor | None  # device tiling
    tiles_host: np.ndarray | None   # host tiling
    timings: dict


@dataclass
class _PendingRun:
    """Per-chunk state between :meth:`DualModelWSIPipeline._plan_segment`
    and :meth:`DualModelWSIPipeline._finish`."""

    gray_shape: tuple
    h: int
    w: int
    n_tiles: int
    n_good: int
    n_positive: int
    timings: dict
    stripes: list  # [(y0, HostCopy of the finalized stripe)]
    hs: int        # stripe height


class DualModelWSIPipeline:
    def __init__(
        self,
        classifier_predict,  # (variables, tiles (B,T,T) uint8) -> (B,) probabilities
        classifier_variables,
        segmenter_predict,   # (params, tiles (B,T,T) uint8) -> (B,T,T) probabilities
        segmenter_params,
        tile_size: int = 1024,
        overlap: float = 0.0,
        classifier_threshold: float = 0.5,
        batch_size: int = 16,  # the U-Net's serving batch at 1024^2
        white_threshold: float = 235.0,
        white_ratio: float = 0.70,
        blur_threshold: float = 7.5,
        blend_sigma_factor: float = 0.25,
        transfer_dtype: str = "float16",  # 'float16' | 'float32' | 'uint8'
        device_tiling: bool = True,
        device="cuda",
        group=None,
    ):
        """``device``: where the slide, both models and the canvases live;
        the predict callables run on tensors on it. ``group``: the ranks
        that share the tile stream (see the module's docstring); every rank
        of it runs the same chunks."""
        self.classifier_predict = classifier_predict
        self.classifier_variables = classifier_variables
        self.segmenter_predict = segmenter_predict
        self.segmenter_params = segmenter_params
        self.tile_size = tile_size
        self.overlap = overlap
        self.classifier_threshold = classifier_threshold
        self.group = group
        if group is not None:
            n = dist.get_world_size(group)
            batch_size = -(-batch_size // n) * n  # rounded up to the ranks
        self.batch_size = batch_size
        self.qc_args = (white_threshold, white_ratio, blur_threshold)
        self.device = torch.device(device)
        self.weight_map = gaussian_weight_map(tile_size, blend_sigma_factor, self.device)
        # Final-map copy precision. float16 halves the device->host copy at
        # a quantization error <= 5e-4 on [0, 1] probabilities, inside the
        # model's bf16 noise; 'float32' copies exactly; 'uint8' quantizes to
        # the PNG payload on the device (exact for the saved probability
        # artifact, 1/255-step probability_map).
        self.transfer_dtype = transfer_dtype
        # Device tiling uploads the slide's bytes once; host tiling uploads
        # every overlapping tile for QC/classify and the positive ones again
        # (under a group, each rank its share).
        self.device_tiling = device_tiling and group is None
        # weight canvases by padded chunk shape, the 2 most recent: they
        # depend only on the shape, and each is one f32 canvas on the device
        self._wsum: dict = {}

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor without a host wait (pinned staging:
        a pageable copy would wait for all work queued on the stream)."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cpu":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def run(self, image: np.ndarray) -> PipelineResult:
        return self._finish(self._dispatch(image, sync_segment=True))

    def run_many(self, images) -> list[PipelineResult]:
        """Run several chunks through a two-stage pipeline.

        A gigapixel WSI arrives as a sequence of <= 6144^2 chunks
        (``wsi/chunker.py``). Back-to-back :meth:`run` calls would leave the
        device idle while the host waits for chunk k's QC result and
        assembles its map. Here the per-chunk work is split at its one data
        dependency, the QC/classify result that picks the positive tiles:
        chunk k+1's QC is enqueued BEFORE the host waits for chunk k's, and
        chunk k's segmentation is enqueued before chunk k-1's map is
        assembled on the host. Outputs are identical to per-image
        :meth:`run` calls.

        In this mode (``pipelined: true`` in each chunk's timings)
        ``qc_classify_s`` and ``segment_s`` time the enqueueing only; the
        wait for the QC result shows as ``qc_wait_s`` and the wait for the
        device and the stripe copies lands in ``blend_s``.
        """
        return list(self.run_many_iter(images))

    def run_many_iter(self, images):
        """Generator form of :meth:`run_many`: yields each chunk's
        :class:`PipelineResult` as soon as its successors are enqueued, so a
        caller can write chunk k's artifacts (and drop its canvas) while
        chunks k+1 and k+2 compute; ``images`` may itself be a lazy
        generator (file reads then overlap the device work too)."""
        pending_qc: _PendingQC | None = None
        pending_seg: _PendingRun | None = None
        for img in images:
            qc = self._dispatch_qc(img)
            if pending_qc is not None:
                seg = self._plan_segment(pending_qc, sync_segment=False)
                if pending_seg is not None:
                    yield self._finish(pending_seg)
                pending_seg = seg
            pending_qc = qc
        if pending_qc is not None:
            seg = self._plan_segment(pending_qc, sync_segment=False)
            if pending_seg is not None:
                yield self._finish(pending_seg)
            yield self._finish(seg)

    def _dispatch(self, image: np.ndarray, sync_segment: bool) -> _PendingRun:
        return self._plan_segment(self._dispatch_qc(image), sync_segment)

    def _share(self, idx: np.ndarray) -> np.ndarray:
        """This rank's equal share of a batch's indices (all of them
        without a group)."""
        if self.group is None:
            return idx
        size = len(idx) // dist.get_world_size(self.group)
        return idx[dist.get_rank(self.group) * size:][:size]

    def _gathered(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's share of a batch's results, concatenated along
        ``dim`` in rank order (``t`` itself without a group)."""
        if self.group is None:
            return t
        return torch.cat(all_gather_tensors(t, self.group), dim=dim)

    def _tiles(self, slide_dev, tiles_host, positions, idx) -> torch.Tensor:
        if slide_dev is not None:
            return extract_tiles(slide_dev, positions[idx], self.tile_size)
        return self._upload(tiles_host[idx])

    def _dispatch_qc(self, image: np.ndarray) -> _PendingQC:
        """Stage 1: pad and tile the chunk, enqueue QC and classification,
        and start the copy of their stacked result. The host does not wait."""
        t = self.tile_size
        timings = {}
        t0 = time.time()
        h, w = image.shape[:2]
        gray = image if image.ndim == 2 else cv2.cvtColor(image, cv2.COLOR_RGB2GRAY)
        if gray.dtype not in (np.uint8, np.float32):
            gray = gray.astype(np.float32)
        pad_h, pad_w = max(0, t - h), max(0, t - w)
        if pad_h or pad_w:
            gray = np.pad(gray, ((0, pad_h), (0, pad_w)), mode="reflect")
        positions = sliding_window_positions(gray.shape, t, self.overlap)
        slide_dev = tiles_host = None
        if self.device_tiling:
            slide_dev = self._upload(gray)
        else:
            tiles_host = np.stack([gray[y:y + t, x:x + t] for y, x in positions.tolist()])
        timings["tiling_s"] = time.time() - t0

        # QC and classification: one tile batch feeds both (the classifier
        # runs on every tile, cheaper than a second pass over the good
        # ones); one stacked result, one copy to the host.
        t0 = time.time()
        outs = []
        for idx, _ in self._chunk_indices(np.arange(len(positions))):
            tiles = self._tiles(slide_dev, tiles_host, positions, self._share(idx))
            good = classify_tiles_batch(tiles, *self.qc_args)["is_good"]
            prob = self.classifier_predict(self.classifier_variables, tiles)
            outs.append(self._gathered(
                torch.stack([good.to(torch.float32), prob.to(torch.float32)]), 1))
        result = HostCopy.start(torch.cat(outs, dim=1))
        timings["qc_classify_s"] = time.time() - t0
        return _PendingQC(gray_shape=gray.shape, h=h, w=w, n_tiles=len(positions),
                          positions=positions, result=result, slide_dev=slide_dev,
                          tiles_host=tiles_host, timings=timings)

    def _chunk_indices(self, index_list):
        """Yield (batch-padded index array, n valid) chunks."""
        b = self.batch_size
        for i in range(0, len(index_list), b):
            idx = index_list[i : i + b]
            n = len(idx)
            yield np.pad(idx, (0, b - n), mode="edge"), n

    def _weight_canvas(self, gray_shape: tuple, positions: np.ndarray) -> torch.Tensor:
        """The blend's denominator canvas for a padded chunk shape, cached:
        positions and batching follow from the shape alone."""
        key = tuple(gray_shape)
        wsum = self._wsum.pop(key, None)
        if wsum is None:
            wsum = torch.zeros(key, dtype=torch.float32, device=self.device)
            b = self.batch_size
            for idx, n in self._chunk_indices(np.arange(len(positions))):
                accumulate_weights(wsum, positions[idx], self.weight_map, np.arange(b) < n)
            while len(self._wsum) > 1:
                del self._wsum[next(iter(self._wsum))]
        self._wsum[key] = wsum  # most recent last
        return wsum

    def _plan_segment(self, qc: _PendingQC, sync_segment: bool) -> _PendingRun:
        """Stage 2: wait for the QC/classify result, pick the positive
        tiles, enqueue their segmentation and the striped finalize."""
        timings = qc.timings
        positions, n_tiles = qc.positions, qc.n_tiles
        b = self.batch_size

        t0 = time.time()
        # pad entries sit only at the tail of the last batch (edge pad), so
        # the [:n_tiles] prefix is exactly the real tiles
        flat = qc.result.numpy()[:, :n_tiles]
        good = flat[0] > 0.5
        probs = np.where(good, flat[1], 0.0).astype(np.float32)
        positive = good & (probs >= self.classifier_threshold)
        timings["qc_wait_s"] = time.time() - t0

        t0 = time.time()
        acc = torch.zeros(qc.gray_shape, dtype=torch.float32, device=self.device)
        wsum = self._weight_canvas(qc.gray_shape, positions)
        timings["blend_weights_s"] = time.time() - t0

        t0 = time.time()
        timings["striped"] = self.group is None
        timings["pipelined"] = not sync_segment
        pos_idx = np.flatnonzero(positive)
        # Striped finalize: canvas stripe [y0, y0 + hs) receives
        # contributions only from tiles whose row start is < y0 + hs, and
        # positive indices are row-major, so it is final once a prefix of
        # the positive batches is enqueued. All stripes share one height
        # (the tile-row stride, starts clamped to the canvas): a clamped
        # stripe overlaps its predecessor and finalizes those rows to the
        # same values.
        # Under a group the whole canvas is one stripe, final after the last
        # batch.
        height = qc.gray_shape[0]
        ys = positions[:, 0]
        row_starts = np.unique(ys)
        hs = (int(row_starts[1] - row_starts[0])
              if len(row_starts) > 1 and self.group is None else height)
        y0s = np.unique(np.minimum(np.arange(0, height, hs), height - hs))
        need = np.ceil(np.searchsorted(ys[pos_idx], y0s + hs, side="left") / b).astype(int)
        stripes = []
        next_s = 0

        def flush(done_batches: int) -> None:
            nonlocal next_s
            while next_s < len(y0s) and need[next_s] <= done_batches:
                y0 = int(y0s[next_s])
                stripe = finalize_blend_stripe(acc, wsum, y0, hs, out_dtype=self.transfer_dtype)
                stripes.append((y0, HostCopy.start(stripe)))
                next_s += 1

        flush(0)
        for done, (idx, n) in enumerate(self._chunk_indices(pos_idx), start=1):
            tiles = self._tiles(qc.slide_dev, qc.tiles_host, positions, self._share(idx))
            seg = self._gathered(self.segmenter_predict(self.segmenter_params, tiles), 0)
            accumulate_predictions(acc, seg, positions[idx], self.weight_map, np.arange(b) < n)
            flush(done)
        # in pipelined mode the next chunk's work overlaps the device drain
        if sync_segment and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        timings["segment_s"] = time.time() - t0
        return _PendingRun(gray_shape=qc.gray_shape, h=qc.h, w=qc.w, n_tiles=n_tiles,
                           n_good=int(good.sum()), n_positive=int(positive.sum()),
                           timings=timings, stripes=stripes, hs=hs)

    def _finish(self, st: _PendingRun) -> PipelineResult:
        """Host-side completion: wait for the stripe copies, assemble the
        map, close the timing attribution."""
        timings = st.timings
        t0 = time.time()
        parts = [(y0, copy.numpy()) for y0, copy in st.stripes]
        buf = np.empty(st.gray_shape, dtype=parts[0][1].dtype)
        for y0, part in parts:
            buf[y0 : y0 + st.hs] = part
        prob_u8 = None
        if self.transfer_dtype == "uint8":
            prob_u8 = buf[: st.h, : st.w]
            full = prob_u8.astype(np.float32) / 255.0
        else:
            full = buf[: st.h, : st.w].astype(np.float32)
        # the stripes were enqueued with the segmentation; blend_s is the
        # weight canvas plus the wait for the copies and the assembly
        timings["blend_s"] = time.time() - t0 + timings.pop("blend_weights_s")
        return PipelineResult(probability_map=full, n_tiles=st.n_tiles, n_good=st.n_good,
                              n_positive=st.n_positive, timings=timings,
                              probability_u8=prob_u8)

    @staticmethod
    def _read_image(image_path: str | Path) -> np.ndarray:
        image = cv2.imread(str(image_path), cv2.IMREAD_UNCHANGED)
        if image is None:
            raise ValueError(f"cannot read {image_path}")
        if image.dtype == np.uint16:
            image = (image / 257.0).astype(np.uint8)
        # run() takes grayscale or RGB; cv2.imread returns BGR(A)
        if image.ndim == 3:
            code = cv2.COLOR_BGRA2RGB if image.shape[2] == 4 else cv2.COLOR_BGR2RGB
            image = cv2.cvtColor(image, code)
        return image

    @staticmethod
    def _write_outputs(image_path: str | Path, result: PipelineResult,
                       output_dir: str | Path, threshold: float) -> dict:
        out = Path(output_dir)
        out.mkdir(parents=True, exist_ok=True)
        stem = Path(image_path).stem
        prob_png = (result.probability_u8 if result.probability_u8 is not None
                    else (np.clip(result.probability_map, 0, 1) * 255).astype(np.uint8))
        cv2.imwrite(str(out / f"{stem}_probability.png"), prob_png)
        cv2.imwrite(str(out / f"{stem}_mask.png"),
                    ((result.probability_map > threshold) * 255).astype(np.uint8))
        summary = {
            "chunk": stem,
            "n_tiles": result.n_tiles,
            "n_good": result.n_good,
            "n_positive": result.n_positive,
            "timings": result.timings,
        }
        (out / f"{stem}_pipeline_log.json").write_text(json.dumps(summary, indent=2))
        return summary

    def run_file(self, image_path: str | Path, output_dir: str | Path,
                 threshold: float = 0.5) -> PipelineResult:
        result = self.run(self._read_image(image_path))
        self._write_outputs(image_path, result, output_dir, threshold)
        return result

    def run_files(self, image_paths, output_dir: str | Path,
                  threshold: float = 0.5) -> list[dict]:
        """Chunk-directory runner: every file flows through the pipelined
        :meth:`run_many_iter` (chunk k+1's read and enqueueing overlap chunk
        k's copies, assembly and writes); artifacts are written and
        canvases dropped as each chunk completes, so a large chunk set runs
        at constant host memory. Returns per-chunk summary dicts and writes
        a directory-level ``pipeline_log.json``."""
        paths = [Path(p) for p in image_paths]
        Path(output_dir).mkdir(parents=True, exist_ok=True)
        summaries = []
        t0 = time.time()
        lazy_reads = (self._read_image(p) for p in paths)
        for p, r in zip(paths, self.run_many_iter(lazy_reads)):
            summaries.append(self._write_outputs(p, r, output_dir, threshold))
        log = {
            "n_chunks": len(paths),
            "total_s": time.time() - t0,
            "n_tiles": sum(s["n_tiles"] for s in summaries),
            "n_positive": sum(s["n_positive"] for s in summaries),
            "chunks": summaries,
        }
        (Path(output_dir) / "pipeline_log.json").write_text(json.dumps(log, indent=2))
        return summaries
