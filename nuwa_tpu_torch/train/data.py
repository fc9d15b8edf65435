"""Host-side data pipeline (numpy): the port's own copy of
``nuwa_tpu/train/data.py``, so that the same seed gives the same items in
the same order as the JAX trainers.

Datasets: image folders (``ImageDataset``, random horizontal flips) and
uint8 image memmaps (``MemmappedImageDataset``, random 90° rotations, read
through the port's g++ batch loader, ``nuwa_tpu_torch.native``), both
drawing from ``random.Random(seed)`` in the JAX package's order;
moving-MNIST memmaps (``MnistDataset``); pre-tokenized video-index memmaps
(``VideoIndicesDataset``) and ``convert_video_dataset_to_indices``, which
writes them through the port's codec; folders of gif and caption pairs
(``GifVideoDataset``). Only the image-file and gif readers need Pillow, and
import it when they read.

Loaders emit numpy arrays; ``stack_microbatches`` groups a gradient
accumulation window into one leading axis of shape (accum, batch, ...).
"""
from __future__ import annotations

import random
from pathlib import Path

import numpy as np


def cycle(iterable_fn):
    while True:
        yield from iterable_fn()


def accum_log(log, new_logs):
    for k, v in new_logs.items():
        log[k] = log.get(k, 0.0) + v
    return log


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------


def _load_image(path, image_size, channels=3, flip_p=0.5, rng=None):
    """An image file -> float32 (c, h, w) in [0, 1]: the shorter side resized
    to ``image_size``, a centre crop, a horizontal flip with ``flip_p``."""
    from PIL import Image

    img = Image.open(path)
    if channels == 3 and img.mode != "RGB":
        img = img.convert("RGB")
    if channels == 1 and img.mode != "L":
        img = img.convert("L")
    w, h = img.size
    scale = image_size / min(w, h)
    img = img.resize((max(image_size, round(w * scale)), max(image_size, round(h * scale))))
    w, h = img.size
    left, top = (w - image_size) // 2, (h - image_size) // 2
    img = img.crop((left, top, left + image_size, top + image_size))
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if rng is not None and rng.random() < flip_p:
        arr = arr[:, ::-1]
    return np.ascontiguousarray(arr.transpose(2, 0, 1))


class ImageDataset:
    """Folder of images -> float32 (c, h, w) in [0, 1] with random h-flip."""

    def __init__(self, folder, image_size, exts=("jpg", "jpeg", "png"), channels=3, seed=0):
        self.paths = sorted(p for ext in exts for p in Path(folder).glob(f"**/*.{ext}"))
        print(f"{len(self.paths)} training samples found at {folder}")
        self.image_size = image_size
        self.channels = channels
        self.rng = random.Random(seed)

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, index):
        return _load_image(self.paths[index], self.image_size, self.channels, rng=self.rng)


class MemmappedImageDataset:
    """uint8 ``np.memmap`` of images with optional random 90° rotations,
    read and rotated by the batch loader (``native``), which raises if it
    cannot be built."""

    def __init__(self, *, path, shape, random_rotate=True, seed=0):
        path = Path(path)
        if not path.exists():
            raise FileNotFoundError(f"path {path} must exist")
        self.memmap = np.memmap(str(path), mode="r", dtype=np.uint8, shape=shape)
        self.random_rotate = random_rotate
        self.rng = random.Random(seed)

    def __len__(self):
        return self.memmap.shape[0]

    def __getitem__(self, index):
        from ..native import gather_normalize_f32, rot90_f32

        arr = gather_normalize_f32(self.memmap, np.asarray([index]))[0]
        if arr.ndim == 2:
            arr = arr[None]
        if self.random_rotate:
            arr = rot90_f32(arr, self.rng.choice([0, 1, 2, 3]))
        return arr  # (c, h, w)


def _default_tokenizer(tokenizer):
    if tokenizer is None:
        from ..tokenizer import tokenizer
    return tokenizer


def _encode(tokenizer, text):
    return np.asarray(tokenizer.encode(text), dtype=np.int64)


class MnistDataset:
    """Moving-MNIST-style memmap videos and digit labels -> (text, video)."""

    def __init__(self, num_videos, videos_memmap_path, text_memmap_path, num_digits=2,
                 num_frames=10, image_size=64, channels=1, random_rotate=False,
                 tokenizer=None, seed=0):
        self.num_videos = num_videos
        self.videos = np.memmap(videos_memmap_path, mode="r", dtype=np.uint8,
                                shape=(num_videos, num_frames, channels, image_size, image_size))
        self.texts = np.memmap(text_memmap_path, mode="r", dtype=np.uint8,
                               shape=(num_videos, num_digits))
        self.random_rotate = random_rotate
        self.rng = random.Random(seed)
        self.tokenizer = _default_tokenizer(tokenizer)

    def __len__(self):
        return self.num_videos

    def __getitem__(self, idx):
        video = np.asarray(self.videos[idx], dtype=np.float32) / 255.0
        text = _encode(self.tokenizer, " ".join(map(str, self.texts[idx].tolist())))
        if self.random_rotate:
            video = np.rot90(video, self.rng.choice([0, 1, 2, 3]), axes=(-2, -1)).copy()
        return text, video


class VideoIndicesDataset:
    """Pre-tokenized videos: an int64 memmap of codebook indices, and labels."""

    def __init__(self, *, videos_memmap_path, text_memmap_path, vae, num_videos, num_frames,
                 num_digits=2, tokenizer=None):
        self.num_videos = num_videos
        fmap_size = vae.fmap_size
        self.videos = np.memmap(videos_memmap_path, mode="r", dtype=np.int64,
                                shape=(num_videos, num_frames * fmap_size * fmap_size))
        self.texts = np.memmap(text_memmap_path, mode="r", dtype=np.uint8,
                               shape=(num_videos, num_digits))
        self.tokenizer = _default_tokenizer(tokenizer)

    def __len__(self):
        return self.num_videos

    def __getitem__(self, idx):
        video = np.asarray(self.videos[idx], dtype=np.int64)
        text = _encode(self.tokenizer, " ".join(map(str, self.texts[idx].tolist())))
        return text, video


class GifVideoDataset:
    """Folder of .gif and .txt caption pairs matched by stem."""

    def __init__(self, *, folder, channels=1, tokenizer=None):
        folder = Path(folder)
        gif_stems = {str(p.with_suffix("")) for p in folder.glob("**/*.gif")}
        txt_stems = {str(p.with_suffix("")) for p in folder.glob("**/*.txt")}
        self.path_stems = sorted(gif_stems & txt_stems)
        self.channels = channels
        print(f"{len(self.path_stems)} video / text pairs found")
        self.tokenizer = _default_tokenizer(tokenizer)

    def __len__(self):
        return len(self.path_stems)

    def __getitem__(self, idx):
        from ..utils.image import gif_to_array

        stem = self.path_stems[idx]
        text = _encode(self.tokenizer, Path(f"{stem}.txt").read_text())
        return text, gif_to_array(f"{stem}.gif", channels=self.channels)


def convert_video_dataset_to_indices(*, vae, raw_video_dataset, num_frames, path,
                                     batch_size=8):
    """Encode every video of ``raw_video_dataset`` (videos, or (text, video)
    pairs) through the port's codec once, ``batch_size`` videos a call,
    writing an int64 memmap of codebook indices at ``path`` (tokenize once,
    train many). The JAX package's ``vae_params`` and ``vae_state`` are the
    codec's own weights and buffers here."""
    import torch

    num_videos = len(raw_video_dataset)
    if num_videos == 0:
        raise ValueError("the dataset is empty")
    fmap_size = vae.fmap_size
    out = np.memmap(path, mode="w+", dtype=np.int64,
                    shape=(num_videos, num_frames * fmap_size * fmap_size))
    for start in range(0, num_videos, batch_size):
        rows = range(start, min(start + batch_size, num_videos))
        items = [raw_video_dataset[i] for i in rows]
        videos = np.stack([np.asarray(it[1] if isinstance(it, tuple) else it) for it in items])
        with torch.no_grad():
            idx = vae.get_video_indices(torch.from_numpy(videos))
        out[np.asarray(rows)] = idx.reshape(len(items), -1).cpu().numpy()
    out.flush()
    print(f"completed conversion of {num_videos} videos to indices at {path}")
    return path


# ---------------------------------------------------------------------------
# batching
# ---------------------------------------------------------------------------


def pad_collate(batch):
    """Pad ragged 1-D texts with 0, stack videos: [(text, video)] -> (texts, videos)."""
    texts, videos = zip(*batch)
    max_len = max(t.shape[0] for t in texts)
    out = np.zeros((len(texts), max_len), dtype=np.int64)
    for i, t in enumerate(texts):
        out[i, : t.shape[0]] = t
    return out, np.stack(videos)


def _default_collate(items):
    """Plain arrays stacked; (text, video) pairs through ``pad_collate``, the
    NUWA trainer's batches (equal to the JAX package's column stack where
    that one works: texts of one width)."""
    if isinstance(items[0], tuple):
        return pad_collate(items)
    return np.stack(items)


class DataLoader:
    """Yields batches of ``batch_size`` items, ``collate_fn``-ed (default
    ``_default_collate``); with ``shuffle`` the indices are permuted each
    epoch by ``np.random.default_rng(seed)``; with ``drop_last`` the last
    partial batch is dropped."""

    def __init__(self, dataset, batch_size, *, collate_fn=None, shuffle=True, seed=0,
                 drop_last=True):
        self.ds = dataset
        self.batch_size = batch_size
        self.collate = collate_fn if collate_fn is not None else _default_collate
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.drop_last = drop_last

    def __iter__(self):
        n, bs = len(self.ds), self.batch_size
        order = np.arange(n)
        if self.shuffle:
            self.rng.shuffle(order)
        end = n - n % bs if self.drop_last else n
        for start in range(0, end, bs):
            yield self.collate([self.ds[int(i)] for i in order[start : start + bs]])

    def cycle(self):
        while True:
            got = False
            for batch in self:
                got = True
                yield batch
            if not got:  # without this, next() would spin forever
                raise ValueError(
                    f"DataLoader yields no batches (dataset size {len(self.ds)}, "
                    f"batch_size {self.batch_size}, drop_last {self.drop_last})")


def stack_microbatches(iterator, accum):
    """Group ``accum`` consecutive batches into one leading axis: plain
    arrays stacked; tuples column by column, ragged int64 text widths padded
    across the window."""
    while True:
        group = [next(iterator) for _ in range(accum)]
        if not isinstance(group[0], tuple):
            yield np.stack(group)
            continue
        stacked = []
        for col in zip(*group):
            if col[0].ndim >= 2 and col[0].dtype == np.int64 and any(
                c.shape[1] != col[0].shape[1] for c in col
            ):
                width = max(c.shape[1] for c in col)
                col = [np.pad(c, ((0, 0), (0, width - c.shape[1]))) for c in col]
            stacked.append(np.stack(col))
        yield tuple(stacked)
