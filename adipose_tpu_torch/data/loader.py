"""Host-side tile datasets feeding device batches: a copy of
``adipose_tpu/data/loader.py`` (``TileDataset``, ``ClassificationDataset``,
``_BoundedCache``, ``prefetch_batches``); it uses cv2 and numpy only.

Segmentation layout ``<build>/dataset/{train,val,test}/{images,masks}``:
grayscale ``*.jpg``/``*.png`` tiles paired by stem with ``*.tif``/``*.tiff``/
``*.png`` masks. Classification layout ``<split>/{adipose,not_adipose}/*.jpg``,
labels 1 and 0. A byte-budgeted RAM cache of uint8 tiles; the epoch order
from ``np.random.RandomState(seed + epoch)``, so the port's batch order is
the JAX package's; short final batches repeat their last element. The host
decodes and caches uint8 tiles only: augmentation and normalization run on
the device in the trainer's steps. Decoding is thread-parallel within a
batch (cv2 releases the GIL), and :func:`prefetch_batches` decodes the next
batches while the device works on the current one.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterator

import cv2
import numpy as np

from adipose_tpu_torch.core.hostio import io_workers
from adipose_tpu_torch.core.seeding import get_project_seed


def prefetch_batches(iterable, depth: int = 2):
    """Run ``iterable`` on a background thread, keeping up to ``depth``
    batches ready in a bounded queue. Exceptions re-raise at the consumer.

    Abandoning the generator (early break / GC) stops the worker: its queue
    slots are drained so a blocked ``put`` wakes, and the daemon worker checks
    the stop flag before producing more.
    """
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()
    _END, _ERR = object(), object()

    def worker():
        try:
            for item in iterable:
                if stop.is_set():
                    return
                q.put(item)
            q.put(_END)
        except BaseException as e:  # propagate to the consumer
            q.put((_ERR, e))

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, tuple) and len(item) == 2 and item[0] is _ERR:
                raise item[1]
            yield item
    finally:
        stop.set()
        while True:  # free a blocked put so the daemon can observe `stop`
            try:
                q.get_nowait()
            except queue.Empty:
                break


class _BoundedCache:
    """Byte-budgeted insert-if-room tile cache.

    Same admission policy as the reference's ``TileDataset`` cache
    (``train_adipose_unet_v3.py:560-561``: insert while below the cap, no
    eviction — first-seen tiles win), but budgeted in BYTES rather than pair
    count because our tiles are u8 (8× smaller than the reference's f32
    pairs) and sizes vary between the two dataset types. A miss beyond the
    budget simply stays uncached.
    """

    def __init__(self, limit_bytes: int):
        self.limit_bytes = int(limit_bytes)
        self._store: dict = {}
        self._used = 0
        # put() runs concurrently from the decode thread pool (and padded
        # final batches repeat an index, so duplicate-key puts DO happen);
        # the budget check-then-insert must be atomic
        self._lock = threading.Lock()

    def __contains__(self, key) -> bool:
        return key in self._store

    def get(self, key):
        return self._store.get(key)

    def put(self, key, value) -> None:
        arrays = value if isinstance(value, tuple) else (value,)
        nbytes = sum(a.nbytes for a in arrays)
        with self._lock:
            if key in self._store:
                return
            if self._used + nbytes <= self.limit_bytes:
                self._store[key] = value
                self._used += nbytes

    def __len__(self) -> int:
        return len(self._store)


def _imread_gray(path: Path) -> np.ndarray:
    img = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise ValueError(f"Failed to load image: {path}")
    return img


def _imread_mask(path: Path) -> np.ndarray:
    m = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if m is None:
        raise ValueError(f"Failed to load mask: {path}")
    if m.ndim == 3:
        m = m[..., 0]
    return (m > 0).astype(np.uint8)


class TileDataset:
    """Paired image/mask tiles with RAM cache and deterministic epoch order."""

    def __init__(
        self,
        images_dir: str | Path,
        masks_dir: str | Path,
        batch_size: int,
        cache: bool = True,
        seed: int | None = None,
        cache_limit_mb: int = 4096,
    ):
        self.images_dir = Path(images_dir)
        self.masks_dir = Path(masks_dir)
        self.batch_size = batch_size
        self.seed = get_project_seed() if seed is None else seed
        image_files = sorted(self.images_dir.glob("*.jpg")) + sorted(
            self.images_dir.glob("*.png")
        )
        mask_files = {}
        for ext in ("*.tif", "*.tiff", "*.png"):
            for p in self.masks_dir.glob(ext):
                mask_files.setdefault(p.stem, p)
        self.pairs = [
            (p, mask_files[p.stem]) for p in image_files if p.stem in mask_files
        ]
        self._cache = (_BoundedCache(cache_limit_mb << 20)
                       if cache and cache_limit_mb > 0 else None)
        self._pool: ThreadPoolExecutor | None = None

    def _decode_pool(self) -> ThreadPoolExecutor:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=io_workers(), thread_name_prefix="tile-decode",
            )
        return self._pool

    def __len__(self) -> int:
        return len(self.pairs)

    @property
    def steps_per_epoch(self) -> int:
        return max(1, (len(self.pairs) + self.batch_size - 1) // self.batch_size)

    def load_pair(self, idx: int):
        img_path, mask_path = self.pairs[idx]
        key = img_path.stem
        if self._cache is not None and key in self._cache:
            return self._cache.get(key)
        img = _imread_gray(img_path)
        mask = _imread_mask(mask_path)
        if self._cache is not None:
            self._cache.put(key, (img, mask))
        return img, mask

    def epoch_batches(self, epoch: int, shuffle: bool = True,
                      rows: tuple[int, int] | None = None) -> Iterator[tuple]:
        """Yield (images u8 (B,H,W), masks u8 (B,H,W)) numpy batches.

        Epoch order derives from (seed, epoch) so any epoch is reproducible in
        isolation; short final batches repeat the last element
        (``train_adipose_unet_v3.py:600-602``). ``rows`` = (start, size):
        decode and yield only those rows of each batch (one process's share
        of a global batch).
        """
        indices = np.arange(len(self.pairs))
        if shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(indices)
        for i in range(0, len(indices), self.batch_size):
            batch_idx = list(indices[i : i + self.batch_size])
            while len(batch_idx) < self.batch_size:
                batch_idx.append(batch_idx[-1])
            if rows is not None:
                batch_idx = batch_idx[rows[0]:rows[0] + rows[1]]
            # thread-parallel decode (order-preserving); cv2 releases the GIL
            imgs, masks = zip(*self._decode_pool().map(self.load_pair, batch_idx))
            yield np.stack(imgs), np.stack(masks)


class ClassificationDataset:
    """Keras-style class-folder dataset: ``<split>/{adipose,not_adipose}/*.jpg``
    (``Classification/train_adipose_classifier_v0.py:135-150``), positives
    first, each class sorted; yields (uint8 (B, H, W), float32 (B,) labels)."""

    def __init__(self, split_dir: str | Path, batch_size: int,
                 seed: int | None = None, cache_limit_mb: int = 4096):
        self.split_dir = Path(split_dir)
        self.batch_size = batch_size
        self.seed = get_project_seed() if seed is None else seed
        pos = sorted((self.split_dir / "adipose").glob("*.jpg"))
        neg = sorted((self.split_dir / "not_adipose").glob("*.jpg"))
        self.files = pos + neg
        self.labels = np.array([1] * len(pos) + [0] * len(neg), np.float32)
        self._cache = _BoundedCache(max(0, cache_limit_mb) << 20)
        self._pool: ThreadPoolExecutor | None = None

    def _decode_pool(self) -> ThreadPoolExecutor:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=io_workers(), thread_name_prefix="cls-decode",
            )
        return self._pool

    def __len__(self) -> int:
        return len(self.files)

    @property
    def steps_per_epoch(self) -> int:
        return max(1, (len(self.files) + self.batch_size - 1) // self.batch_size)

    def class_counts(self) -> tuple:
        n_pos = int(self.labels.sum())
        return n_pos, len(self.labels) - n_pos

    def load(self, idx: int) -> np.ndarray:
        if idx in self._cache:
            return self._cache.get(idx)
        img = _imread_gray(self.files[idx])
        self._cache.put(idx, img)
        return img

    def epoch_batches(self, epoch: int, shuffle: bool = True,
                      rows: tuple[int, int] | None = None) -> Iterator[tuple]:
        """The epoch's batches in the order of ``RandomState(seed + epoch)``;
        a short final batch repeats its last index. ``rows`` = (start,
        size): only those rows of each batch."""
        indices = np.arange(len(self.files))
        if shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(indices)
        for i in range(0, len(indices), self.batch_size):
            batch_idx = list(indices[i : i + self.batch_size])
            while len(batch_idx) < self.batch_size:
                batch_idx.append(batch_idx[-1])
            if rows is not None:
                batch_idx = batch_idx[rows[0]:rows[0] + rows[1]]
            imgs = np.stack(list(self._decode_pool().map(self.load, batch_idx)))
            yield imgs, self.labels[batch_idx]
