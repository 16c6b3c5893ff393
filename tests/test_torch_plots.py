"""The training-history plot, the epoch deltas, the montage and the
augmentation visualizer on the CPU: the port's ``train/plots.py``,
``data/montage.py`` and ``data/visualize_augment.py`` against the JAX
package's, and a tiny ``adipose-torch train-unet --device cpu`` run that
writes ``training_history.png``. Figures are cv2 drawings, so they are held
to the JAX figure's size and layout, not its pixels.
"""

import csv
import math

import cv2
import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from adipose_tpu.data import montage as jax_montage
from adipose_tpu.train import plots as jax_plots
from adipose_tpu_torch.cli.main import main as torch_main
from adipose_tpu_torch.core.charts import Figure
from adipose_tpu_torch.data import montage
from adipose_tpu_torch.data.visualize_augment import augmented_examples, visualize_augmentation
from adipose_tpu_torch.train import plots

PHASE_COLUMNS = ["epoch", "loss", "dice_coef", "val_loss", "val_dice_coef", "lr", "epoch_time_s"]


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """Tier-1 runs six test processes on one shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def write_log(path, columns, n, seed):
    rs = np.random.RandomState(seed)
    with path.open("w", newline="") as f:
        w = csv.writer(f)
        w.writerow(columns)
        for e in range(n):
            w.writerow([e] + [float(v) for v in rs.rand(len(columns) - 1)])


def jax_history(ckpt_dir):
    """The JAX function's concatenated frame, rebuilt as it builds it."""
    frames = []
    for phase in (1, 2):
        f = ckpt_dir / f"phase{phase}_training.log"
        if f.exists():
            df = pd.read_csv(f)
            df["phase"] = phase
            frames.append(df)
    if not frames:
        df = pd.read_csv(ckpt_dir / "training.log")
        df["phase"] = 1
        frames.append(df)
    hist = pd.concat(frames, ignore_index=True)
    hist["global_epoch"] = range(len(hist))
    return hist


@pytest.mark.parametrize("case", ["two_phases", "single_log", "phase2_extra_column"])
def test_training_history_matches_jax(tmp_path, case):
    """The port's concatenated history equals pandas' frame (columns, order,
    values, NaN where a phase lacks a column); both figures are one panel a
    plotted metric in min(3, n) columns of 4 x 3 inches at 120 dpi."""
    if case == "single_log":
        write_log(tmp_path / "training.log", ["epoch", "loss", "acc", "val_auc", "val_acc", "lr",
                                              "epoch_time_s"], 4, 0)
    else:
        write_log(tmp_path / "phase1_training.log", PHASE_COLUMNS, 3, 1)
        extra = ["act_std"] if case == "phase2_extra_column" else []
        write_log(tmp_path / "phase2_training.log", PHASE_COLUMNS + extra, 2, 2)
    columns, rows = plots.training_history(tmp_path)
    want = jax_history(tmp_path)
    assert columns == list(want.columns)
    got = pd.DataFrame(rows, columns=columns)
    # pandas' default CSV float parser is not correctly rounded (float() is):
    # the values (in [0, 9] here) agree to 1e-14 relative or 1e-15 absolute
    # (measured 8.7e-17 on 1.1e-4), NaN where NaN
    np.testing.assert_allclose(got.to_numpy(np.float64), want.to_numpy(np.float64), rtol=1e-14,
                               atol=1e-15)

    out_jax = jax_plots.plot_training_history(tmp_path, tmp_path / "jax.png")
    out = plots.plot_training_history(tmp_path)
    assert out == tmp_path / "training_history.png"
    metrics = [c for c in columns if c not in ("epoch", "phase", "global_epoch", "epoch_time_s",
                                               "lr") and not c.startswith("val_")]
    ncol = min(3, len(metrics))
    nrow = math.ceil(len(metrics) / ncol)
    shape = cv2.imread(str(out)).shape
    assert shape == (3 * nrow * 120, 4 * ncol * 120, 3)
    with Image.open(out_jax) as im:
        assert (im.size[1], im.size[0]) == shape[:2]


def test_missing_logs_raise_like_jax(tmp_path):
    with pytest.raises(FileNotFoundError):
        jax_plots.plot_training_history(tmp_path)
    with pytest.raises(FileNotFoundError, match="no training logs"):
        plots.plot_training_history(tmp_path)


def test_log_epoch_deltas_equal_jax():
    history = [{"epoch": 0, "loss": 0.9, "dice": 0.1, "note": "x"},
               {"epoch": 1, "loss": 0.7, "dice": 0.35, "new": 3},
               {"epoch": 2, "loss": 0.75, "dice": 0.35}]
    assert plots.log_epoch_deltas(history) == jax_plots.log_epoch_deltas(history)
    assert plots.log_epoch_deltas([]) == []


def test_train_unet_writes_the_history_plot(tmp_path):
    """A tiny run at the CLI defaults on 64^2 tiles ends with
    ``training_history.png``: a panel for each logged train metric."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[:64, :64]
    for split in ("train", "val"):
        for sub in ("images", "masks"):
            (tmp_path / "dataset" / split / sub).mkdir(parents=True)
        for i in range(2):
            cy, cx = rng.integers(0, 64, 2)
            m = ((yy - cy) ** 2 + (xx - cx) ** 2 < 16**2).astype(np.uint8)
            img = (rng.random((64, 64)) * 60 + 80 + 80 * m).astype(np.uint8)
            cv2.imwrite(str(tmp_path / "dataset" / split / "images" / f"t{i}.jpg"), img)
            cv2.imwrite(str(tmp_path / "dataset" / split / "masks" / f"t{i}.tif"), m * 255)
    torch_main(["train-unet", "--data-root", str(tmp_path), "--epochs-phase1", "1",
                "--epochs-phase2", "1", "--device", "cpu", "--checkpoint-root",
                str(tmp_path / "ck"), "--run-timestamp", "t0"])
    run = tmp_path / "ck" / "t0_adipose_sybreosin_1024_finetune_v3"
    png = cv2.imread(str(run / "training_history.png"))
    columns, _ = plots.training_history(run)
    n = len([c for c in columns if c not in ("epoch", "phase", "global_epoch", "epoch_time_s",
                                             "lr") and not c.startswith("val_")])
    ncol = min(3, n)
    assert n >= 2 and png is not None
    assert png.shape == (3 * math.ceil(n / ncol) * 120, 4 * ncol * 120, 3)


# ---- the montage (numpy and PIL) ---------------------------------------------------


def test_montage_pairs_bit_equal_jax():
    rs = np.random.RandomState(865)
    imgs = (rs.rand(7, 8, 6) * 255).astype(np.uint8)
    msks = (rs.rand(7, 8, 6) > 0.5).astype(np.uint8) * 255
    got = montage.montage_pairs(imgs, msks, 2, 3, np.random.RandomState(4))
    want = jax_montage.montage_pairs(imgs, msks, 2, 3, np.random.RandomState(4))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        montage.montage_pairs(imgs, msks, 3, 3, np.random.RandomState(0))


def test_isbi_get_data_montage_bit_equal_jax(tmp_path):
    rs = np.random.RandomState(1)
    paths = []
    for name, stack in (("imgs", (rs.rand(5, 8, 8) * 255).astype(np.uint8)),
                        ("msks", (rs.rand(5, 8, 8) > 0.5).astype(np.uint8) * 255)):
        frames = [Image.fromarray(s) for s in stack]
        frames[0].save(tmp_path / f"{name}.tif", save_all=True, append_images=frames[1:])
        paths.append(tmp_path / f"{name}.tif")
    got = montage.isbi_get_data_montage(*paths, 2, 2, np.random.RandomState(0))
    want = jax_montage.isbi_get_data_montage(*paths, 2, 2, np.random.RandomState(0))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(montage.load_tiff_stack(paths[0]),
                                  jax_montage.load_tiff_stack(paths[0]))


# ---- the augmentation visualizer ---------------------------------------------------


def test_visualize_augmentation_grid(tmp_path):
    """N rows of [original | augmented | mask], 9 x 3N inches at 120 dpi; the
    original column is the image itself, the same seed gives the same
    examples, and the masks stay binary."""
    rs = np.random.RandomState(2)
    image = (rs.rand(32, 32) * 200 + 20).astype(np.float32)
    mask = (rs.rand(32, 32) > 0.5).astype(np.float32)
    out = visualize_augmentation(image, mask, "heavy", 3, tmp_path / "aug.png", seed=7,
                                 device="cpu")
    png = cv2.imread(str(out), cv2.IMREAD_GRAYSCALE)
    assert png.shape == (3 * 3 * 120, 9 * 120)
    fig = visualize_augmentation(image, mask, "heavy", 3, seed=7, device="cpu")
    np.testing.assert_array_equal(fig.img[..., 0], png)
    # each row's first panel is the original image, drawn as a lone panel
    # of the same figure draws it; the augmented panels differ from it
    ref = Figure(9, 9, 120, 3, 3)
    for r in range(3):
        ref.panel(r, 0).image(image, "Original")
        x0, y0, x1, y1 = ref.panel(r, 0).box
        np.testing.assert_array_equal(fig.img[y0:y1, x0:x1], ref.img[y0:y1, x0:x1])
        ax0, ay0, ax1, ay1 = ref.panel(r, 1).box
        assert not np.array_equal(fig.img[ay0:ay1, ax0:ax1], ref.img[y0:y1, x0:x1])
    a, b = (augmented_examples(image, mask, "heavy", 2, seed=7, device="cpu") for _ in range(2))
    for (ia, ma), (ib, mb) in zip(a, b):
        np.testing.assert_array_equal(ia, ib)
        assert set(np.unique(ma)) <= {0.0, 1.0}
    assert not np.array_equal(a[0][0], a[1][0])
