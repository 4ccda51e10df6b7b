"""Dataset loaders (counterpart of `mm_unet_tpu/data/loaders.py`: the same
batches for the same config and seed, on the native and the numpy
pipeline): directory-paired vessel sets (DRIVE/STARE/CHASE_DB1), polyp
single-directory ratio splits (CVC-ClinicDB/Kvasir-SEG/PolypGen/SUN-SEG),
EDD 5-class mask assembly, and a synthetic set when no data is mounted.

- Vessel sets scan `<root>/<phase>/{input,label}` with label pattern
  `{base_name}.png` (train) / `{base_name}_manual1.png` (val), load every
  image into RAM, train with flips + resize + normalisation (labels
  binarised > 0.5, then nearest-resized), and centre-pad val images to at
  least `image_size`.
- Polyp sets split one directory by `trainer.train_ratio` and add the
  colour-statistics exchange.
- EDD builds 5-channel masks from per-class `_<key>.tif` files.

Batches are dicts of numpy arrays {image (B,3,H,W), label (B,K,H,W), paths}
with static shapes (train drops the ragged tail batch). PIL is imported
inside the file readers only.
"""

from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass, field
from typing import Iterator, Optional

import numpy as np

from mm_unet_tpu_torch import runtime
from mm_unet_tpu_torch.data import transforms as T
from mm_unet_tpu_torch.data.synthetic import make_synthetic as _synthetic_arrays

EDD_KEY_MAPPING = ("BE", "cancer", "HGD", "polyp", "suspicious")


def _imread(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB"), dtype=np.float32) / 255.0
    return arr


def _imread_mask(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im.convert("L"), dtype=np.float32) / 255.0
    return arr


def pair_directory(phase_root: str, image_subdir: str, label_subdir: str,
                   label_pattern: str) -> list[dict]:
    """Reference `VesselLoader.py:198-230` directory pairing."""
    img_dir = os.path.join(phase_root, image_subdir)
    lbl_dir = os.path.join(phase_root, label_subdir)
    out = []
    if not os.path.isdir(img_dir) or not os.path.isdir(lbl_dir):
        return out
    for fname in sorted(os.listdir(img_dir)):
        base = os.path.splitext(fname)[0]
        lbl = os.path.join(lbl_dir, label_pattern.format(base_name=base))
        img = os.path.join(img_dir, fname)
        if os.path.exists(lbl):
            out.append({"image": img, "label": lbl})
    return out


@dataclass
class ArrayDataset:
    """RAM-resident dataset of (image HWC [0,1], label HW {0,1}) pairs."""

    images: list[np.ndarray]
    labels: list[np.ndarray]
    paths: list[tuple[str, str]] = field(default_factory=list)

    def __len__(self):
        return len(self.images)


class DataLoader:
    """Seeded epoch iterator producing static-shape NCHW batches."""

    def __init__(
        self,
        dataset: ArrayDataset,
        batch_size: int,
        image_size: int,
        mean, std,
        train: bool,
        seed: int = 50,
        num_classes: int = 1,
        pad_val: bool = True,
        cutmix: bool = False,
        color_exchange: bool = False,
        patch_size: Optional[int] = None,
        resized_crop: bool = False,
        color_jitter: bool = False,
        gaussian_blur: bool = False,
        prefetch_depth: int = 2,
    ):
        self.ds = dataset
        self.batch_size = batch_size
        self.image_size = image_size
        self.mean, self.std = mean, std
        self.train = train
        self.rng = np.random.default_rng(seed)
        self.num_classes = num_classes
        self.pad_val = pad_val
        self.cutmix = cutmix
        self.color_exchange = color_exchange
        self.patch_size = patch_size
        self.resized_crop = resized_crop
        self.color_jitter = color_jitter
        self.gaussian_blur = gaussian_blur
        self.prefetch_depth = prefetch_depth
        self.pipeline: Optional[str] = None  # the last batch's: "native" or "numpy"

    def __len__(self):
        n = len(self.ds)
        if self.train:
            return max(n // self.batch_size, 1)
        return -(-n // self.batch_size)

    def _resize_label(self, lbl: np.ndarray, s: int) -> np.ndarray:
        lbl = (lbl > 0.5).astype(np.float32)
        if lbl.ndim == 3:  # multi-class (EDD): per-channel nearest resize
            return np.stack(
                [T.resize_image(lbl[..., c], (s, s), nearest=True)
                 for c in range(lbl.shape[-1])], axis=-1,
            )
        return T.resize_image(lbl, (s, s), nearest=True)

    def _prep(self, img: np.ndarray, lbl: np.ndarray, idx: int):
        s = self.image_size
        if self.train:
            if self.color_exchange and self.rng.random() < 0.5 and len(self.ds) > 1:
                donor = self.ds.images[self.rng.integers(len(self.ds))]
                img = T.lab_color_exchange(self.rng, img, donor)
            img, lbl = T.random_flips(self.rng, img, lbl)
            if self.cutmix and self.rng.random() < 0.5 and len(self.ds) > 1:
                j = int(self.rng.integers(len(self.ds)))
                img, lbl = T.cut_mix(self.rng, img, lbl, self.ds.images[j], self.ds.labels[j])
            if self.color_jitter and self.rng.random() < 0.5:
                img = T.color_jitter(self.rng, img)
            if self.gaussian_blur and self.rng.random() < 0.3:
                img = T.gaussian_blur(self.rng, img)
            if self.patch_size:
                # random patch training (BASELINE: DRIVE 256^2 patches)
                img, lbl = T.random_patch(self.rng, img, lbl, self.patch_size)
                s = self.patch_size
            if self.resized_crop and self.rng.random() < 0.5 and lbl.ndim == 2:
                img, lbl = T.random_resized_crop(self.rng, img, lbl, s)
            img = T.resize_image(img, (s, s))
            lbl = self._resize_label(lbl, s)
        else:
            if self.pad_val:
                img = T.center_padding(img, s, s)
                lbl = T.center_padding(lbl, s, s)
            if img.shape[:2] != (s, s):
                img = T.resize_image(img, (s, s))
                lbl = self._resize_label(lbl, s)
        img = T.normalize(img, self.mean, self.std)
        lbl = (lbl > 0.5).astype(np.float32)
        if lbl.ndim == 2:
            lbl = lbl[..., None]
        return T.to_nchw(img), T.to_nchw(lbl)

    def _native_batch(self, idxs, epoch: int):
        """Threaded C++ batch prep (`mm_unet_tpu_torch.runtime`) — the fast path for
        single-class datasets. Covers flips, CutMix (same-size donors),
        colour jitter, gaussian blur, random-patch and resized-crop; only the
        LAB colour exchange and multi-class EDD masks fall back to numpy."""
        if runtime.get_lib() is None or self.color_exchange:
            return None
        if any(self.ds.labels[j].ndim != 2 for j in idxs):
            return None
        images = [self.ds.images[j] for j in idxs]
        labels = [self.ds.labels[j] for j in idxs]
        donors_i = donors_l = None
        if self.train and self.cutmix and len(self.ds) > 1:
            djs = [int(self.rng.integers(len(self.ds))) for _ in idxs]
            donors_i = [self.ds.images[j] for j in djs]
            donors_l = [self.ds.labels[j] for j in djs]
            # native CutMix copies donor rows in-place: donors must match
            if any(
                d.shape[:2] != im.shape[:2] or dl.ndim != 2
                for d, dl, im in zip(donors_i, donors_l, images)
            ):
                return None
        if not self.train and self.pad_val:
            s = self.image_size
            images = [T.center_padding(im, s, s) for im in images]
            labels = [T.center_padding(lb, s, s) for lb in labels]
        out_size = self.patch_size if (self.train and self.patch_size) else self.image_size
        img, lbl = runtime.prepare_batch(
            images, labels, np.asarray(idxs), out_size,
            self.mean, self.std, seed=int(self.rng.integers(2**31)) if self.train else 0,
            epoch=epoch, train=self.train,
            cutmix_donor_images=donors_i, cutmix_donor_labels=donors_l,
            color_jitter=self.color_jitter, gaussian_blur=self.gaussian_blur,
            resized_crop=self.resized_crop,
            patch=self.patch_size if self.train else 0,
        )
        return img, lbl

    def _batches(self) -> Iterator[dict]:
        n = len(self.ds)
        order = self.rng.permutation(n) if self.train else np.arange(n)
        bs = self.batch_size
        stop = (n // bs) * bs if self.train and n >= bs else n
        self._epoch = getattr(self, "_epoch", -1) + 1
        for i in range(0, max(stop, 1), bs):
            idxs = order[i : i + bs]
            if len(idxs) == 0:
                break
            native = self._native_batch(idxs, self._epoch)
            self.pipeline = "numpy" if native is None else "native"
            if native is not None:
                imgs_arr, lbls_arr = native
            else:
                imgs, lbls = [], []
                for j in idxs:
                    im, lb = self._prep(self.ds.images[j], self.ds.labels[j], j)
                    imgs.append(im)
                    lbls.append(lb)
                imgs_arr = np.stack(imgs).astype(np.float32)
                lbls_arr = np.stack(lbls).astype(np.float32)
            yield {
                "image": imgs_arr,
                "label": lbls_arr,
                "paths": [self.ds.paths[j] if self.ds.paths else ("", "") for j in idxs],
            }

    def __iter__(self) -> Iterator[dict]:
        """Batches are prepared `prefetch_depth` ahead on a background thread
        so host-side augmentation overlaps the device step. When the consumer
        stops early (a preemption breaks the epoch), the thread stops after
        the batch it is preparing and is joined."""
        if self.prefetch_depth <= 0:
            yield from self._batches()
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch_depth)
        done = threading.Event()
        sentinel = object()

        def put(item) -> bool:
            while not done.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for item in self._batches():
                    if not put(item):
                        return
                put(sentinel)
            except BaseException as exc:  # surfaced on the consumer thread
                put(exc)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            done.set()
            t.join()


def _load_vessel(config, dataset_name: str):
    params = config.dataset[dataset_name]
    root = params.data_root
    train_pairs = pair_directory(
        os.path.join(root, params.get("train_dir", "train")),
        params.get("image_subdir", "input"), params.get("label_subdir", "label"),
        params.get("train_label_pattern", "{base_name}.png"),
    )
    val_pairs = pair_directory(
        os.path.join(root, params.get("val_dir", "val")),
        params.get("image_subdir", "input"), params.get("label_subdir", "label"),
        params.get("val_label_pattern", "{base_name}_manual1.png"),
    )

    def make(pairs):
        ds = ArrayDataset([], [], [])
        for p in pairs:
            ds.images.append(_imread(p["image"]))
            ds.labels.append(_imread_mask(p["label"]))
            ds.paths.append((p["image"], p["label"]))
        return ds

    return make(train_pairs), make(val_pairs)


def _load_polyp(config, dataset_name: str):
    """Single-directory ratio split (reference `CVCLoder.py:17-24`)."""
    params = config.dataset[dataset_name]
    root = params.data_root
    img_dir = os.path.join(root, params.get("image_subdir", "images"))
    msk_dir = os.path.join(root, params.get("label_subdir", "masks"))
    names = sorted(os.listdir(img_dir)) if os.path.isdir(img_dir) else []
    ratio = float(config.trainer.get("train_ratio", 0.8))
    n_train = int(len(names) * ratio)

    def make(subset):
        ds = ArrayDataset([], [], [])
        for fname in subset:
            ip = os.path.join(img_dir, fname)
            mp = os.path.join(msk_dir, fname)
            if not os.path.exists(mp):
                base = os.path.splitext(fname)[0]
                for ext in (".png", ".jpg", ".tif"):
                    if os.path.exists(os.path.join(msk_dir, base + ext)):
                        mp = os.path.join(msk_dir, base + ext)
                        break
            if os.path.exists(mp):
                ds.images.append(_imread(ip))
                ds.labels.append(_imread_mask(mp))
                ds.paths.append((ip, mp))
        return ds

    return make(names[:n_train]), make(names[n_train:])


def _load_sunseg(config):
    """SUN-SEG video frames: `TrainDataset/Frame|GT` folders for training,
    `TestHardDataset/Unseen/Frame|GT` for validation (reference
    `SunsegLoader.py:10-42`)."""
    params = config.dataset["Sun_seg"]
    root = params.data_root

    def collect(base):
        ds = ArrayDataset([], [], [])
        f_dir = os.path.join(base, "Frame")
        g_dir = os.path.join(base, "GT")
        if not os.path.isdir(f_dir):
            return ds
        for case in sorted(os.listdir(f_dir)):
            cf, cg = os.path.join(f_dir, case), os.path.join(g_dir, case)
            if not os.path.isdir(cf):
                cf, cg = f_dir, g_dir
            for fname in sorted(os.listdir(cf)):
                base_n = os.path.splitext(fname)[0]
                for ext in (".png", ".jpg", ".tif"):
                    mp = os.path.join(cg, base_n + ext)
                    if os.path.exists(mp):
                        ds.images.append(_imread(os.path.join(cf, fname)))
                        ds.labels.append(_imread_mask(mp))
                        ds.paths.append((os.path.join(cf, fname), mp))
                        break
            if cf is f_dir:
                break
        return ds

    train = collect(os.path.join(root, "TrainDataset"))
    val = collect(os.path.join(root, "TestHardDataset", "Unseen"))
    return train, val


def _load_polypgen(config):
    """PolypGen: per-center folders `data_C{i}` with `images/` and
    `masks/<name>_mask.jpg` labels (reference `PolpyGenLoder.py:12-26`)."""
    params = config.dataset["PolypGen"]
    root = params.data_root
    ds_all = ArrayDataset([], [], [])
    centers = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
    for center in centers:
        img_dir = os.path.join(root, center, "images")
        msk_dir = os.path.join(root, center, "masks")
        if not os.path.isdir(img_dir):
            continue
        for fname in sorted(os.listdir(img_dir)):
            base = os.path.splitext(fname)[0]
            for ext in (".jpg", ".png"):
                mp = os.path.join(msk_dir, f"{base}_mask{ext}")
                if os.path.exists(mp):
                    ds_all.images.append(_imread(os.path.join(img_dir, fname)))
                    ds_all.labels.append(_imread_mask(mp))
                    ds_all.paths.append((os.path.join(img_dir, fname), mp))
                    break
    ratio = float(config.trainer.get("train_ratio", 0.8))
    n_train = int(len(ds_all) * ratio)
    train = ArrayDataset(ds_all.images[:n_train], ds_all.labels[:n_train], ds_all.paths[:n_train])
    val = ArrayDataset(ds_all.images[n_train:], ds_all.labels[n_train:], ds_all.paths[n_train:])
    return train, val


def _load_edd(config):
    """EDD2020 5-class: builds a 5-channel mask from per-class `_<key>.tif`
    files (reference `EDDLoader.py:10-29,49-60`, EDD_KEY_MAPPING)."""
    params = config.dataset["EDD_seg"]
    root = params.data_root
    img_dir = os.path.join(root, params.get("image_subdir", "originalImages"))
    msk_dir = os.path.join(root, params.get("label_subdir", "masks"))
    names = sorted(os.listdir(img_dir)) if os.path.isdir(img_dir) else []
    ratio = float(config.trainer.get("train_ratio", 0.8))
    n_train = int(len(names) * ratio)

    def make(subset):
        ds = ArrayDataset([], [], [])
        for fname in subset:
            base = os.path.splitext(fname)[0]
            img = _imread(os.path.join(img_dir, fname))
            h, w = img.shape[:2]
            mask = np.zeros((h, w, 5), np.float32)
            for ci, key in enumerate(EDD_KEY_MAPPING):
                mp = os.path.join(msk_dir, f"{base}_{key}.tif")
                if os.path.exists(mp):
                    mask[..., ci] = _imread_mask(mp)
            ds.images.append(img)
            ds.labels.append(mask)
            ds.paths.append((os.path.join(img_dir, fname), msk_dir))
        return ds

    return make(names[:n_train]), make(names[n_train:])


def make_synthetic(n: int, hw: int, seed: int = 0) -> ArrayDataset:
    """`mm_unet_tpu_torch.data.make_synthetic`'s images as a dataset."""
    images, labels = _synthetic_arrays(n, hw, seed)
    return ArrayDataset(images, labels, [("synthetic", "synthetic")] * n)


_DATASETS = ("DRIVE", "STARE", "CHASE_DB1", "CVC_ClinicDB", "Kvasir_SEG", "PolypGen",
             "Sun_seg", "EDD_seg")


def get_dataloader(config, dataset_choose: Optional[str] = None):
    """(train_loader, val_loader) for `config.trainer.dataset_choose` (or
    `dataset_choose`): the files under `data_root` when it is mounted, else
    the synthetic set. The val loader has batch 1, as the JAX package's."""
    name = dataset_choose or config.trainer.dataset_choose
    params = config.dataset[name]
    bs = int(params.batch_size)
    size = int(params.image_size)
    mean = params.get("image_mean", [0.485, 0.456, 0.406])
    std = params.get("image_std", [0.229, 0.224, 0.225])
    seed = int(config.trainer.get("seed", 50))

    root = params.get("data_root", "")
    mounted = bool(root) and os.path.isdir(root)
    if mounted and name in ("DRIVE", "STARE", "CHASE_DB1"):
        train_ds, val_ds = _load_vessel(config, name)
    elif mounted and name == "Sun_seg":
        train_ds, val_ds = _load_sunseg(config)
    elif mounted and name == "PolypGen":
        train_ds, val_ds = _load_polypgen(config)
    elif mounted and name in ("CVC_ClinicDB", "Kvasir_SEG"):
        train_ds, val_ds = _load_polyp(config, name)
    elif mounted and name == "EDD_seg":
        train_ds, val_ds = _load_edd(config)
    else:
        # MMU_SYNTH_N sizes the synthetic set of a named dataset that is not
        # mounted (throughput runs need more than 2 steps per epoch)
        n = max(bs * 2, 8)
        if name in _DATASETS:
            n = int(os.environ.get("MMU_SYNTH_N", n))
        train_ds = make_synthetic(n, size, seed)
        val_ds = make_synthetic(2, size, seed + 1)

    if params.get("clahe", False):
        # CLAHE fundus preprocessing applied once at load (RAM-resident data)
        for ds in (train_ds, val_ds):
            ds.images = [T.clahe(im) for im in ds.images]

    color_ex = name in ("CVC_ClinicDB", "Kvasir_SEG")
    train_loader = DataLoader(
        train_ds, bs, size, mean, std, train=True, seed=seed,
        cutmix=bool(params.get("cut_mix", False)), color_exchange=color_ex,
        patch_size=params.get("patch_size"),
        resized_crop=bool(params.get("resized_crop", False)),
        color_jitter=bool(params.get("color_jitter", False)),
        gaussian_blur=bool(params.get("gaussian_blur", False)),
    )
    val_loader = DataLoader(val_ds, 1, size, mean, std, train=False, seed=seed)
    return train_loader, val_loader
