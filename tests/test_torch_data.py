"""Port parity: the host-side data pipeline (``train.data``, ``native``, the
gif helpers of ``utils.image``) against nuwa_tpu's on the same files.

Every dataset gives the JAX package's items in the same order from the same
seed (the flips and rotations drawn by ``random.Random(seed)``); the loader
gives the same batches (shuffle, ``drop_last``, the default collate, the
microbatch windows); gifs written by one package read the same in the
other; ``convert_video_dataset_to_indices`` through the port's codec writes
JAX's indices. Exact: these are copies of host arithmetic.
"""
import jax
import numpy as np
import pytest

from nuwa_tpu import native as jnative
from nuwa_tpu.train import data as jdata
from nuwa_tpu.utils import image as jimage
from nuwa_tpu.vqgan_vae import VQGanVAE as JVAE
from nuwa_tpu_torch import VQGanVAE, native
from nuwa_tpu_torch.convert import load_vqgan_vae
from nuwa_tpu_torch.train import data
from nuwa_tpu_torch.utils import image


def _same(a, b):
    """Items (arrays or tuples of arrays) equal in value, shape and dtype."""
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        return all(_same(x, y) for x, y in zip(a, b))
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)
    return True


def _write_pngs(folder, shapes):
    from PIL import Image

    rng = np.random.default_rng(0)
    for i, shape in enumerate(shapes):
        arr = rng.integers(0, 255, size=shape, dtype=np.uint8)
        Image.fromarray(arr).save(str(folder / f"img{i}.png"))


@pytest.mark.parametrize("channels", [3, 1])
def test_image_dataset_matches_jax(tmp_path, channels):
    """Resize of the shorter side, centre crop, the flips drawn in order
    (each item read twice, so the draws run on)."""
    _write_pngs(tmp_path, [(12, 10, 3), (9, 14), (16, 16, 3), (10, 12, 3)])
    ours = data.ImageDataset(tmp_path, image_size=8, channels=channels, seed=4)
    theirs = jdata.ImageDataset(tmp_path, image_size=8, channels=channels, seed=4)
    assert len(ours) == len(theirs) == 4
    for i in [0, 1, 2, 3, 0, 1, 2, 3]:
        got = ours[i]
        assert _same(got, theirs[i]) and got.shape == (channels, 8, 8)


@pytest.mark.parametrize("rotate", [True, False])
def test_memmapped_image_dataset_and_native_helpers_match_jax(tmp_path, rotate):
    shape = (6, 3, 8, 8)
    mm = np.memmap(tmp_path / "imgs.u8", mode="w+", dtype=np.uint8, shape=shape)
    mm[:] = np.random.default_rng(0).integers(0, 255, size=shape, dtype=np.uint8)
    mm.flush()
    kw = dict(path=tmp_path / "imgs.u8", shape=shape, random_rotate=rotate, seed=2)
    ours, theirs = data.MemmappedImageDataset(**kw), jdata.MemmappedImageDataset(**kw)
    for i in [0, 5, 2, 2, 3, 1, 4, 0]:
        assert _same(ours[i], theirs[i])
    idx = np.array([3, 0, 3])
    assert _same(native.gather_normalize_f32(mm, idx), jnative.gather_normalize_f32(mm, idx))
    assert _same(native.gather_i64(mm.astype(np.int64), idx),
                 jnative.gather_i64(mm.astype(np.int64), idx))
    img = ours[1][:, :, :5].copy()
    for k in range(-1, 5):
        assert _same(native.rot90_f32(img, k), jnative.rot90_f32(img, k))
    with pytest.raises(FileNotFoundError):
        data.MemmappedImageDataset(path=tmp_path / "missing", shape=shape)


def _mnist_files(tmp_path, n=3, f=2, c=1, s=8):
    vids = np.memmap(tmp_path / "v.u8", mode="w+", dtype=np.uint8, shape=(n, f, c, s, s))
    vids[:] = np.random.default_rng(1).integers(0, 255, size=vids.shape, dtype=np.uint8)
    texts = np.memmap(tmp_path / "t.u8", mode="w+", dtype=np.uint8, shape=(n, 2))
    texts[:] = [[1, 2], [3, 4], [5, 6]]
    vids.flush()
    texts.flush()
    return tmp_path / "v.u8", tmp_path / "t.u8"


def test_mnist_dataset_matches_jax(tmp_path):
    v, t = _mnist_files(tmp_path)
    kw = dict(num_frames=2, image_size=8, channels=1, random_rotate=True, seed=5)
    ours, theirs = data.MnistDataset(3, v, t, **kw), jdata.MnistDataset(3, v, t, **kw)
    for i in [0, 1, 2, 1, 0]:
        assert _same(ours[i], theirs[i])


def test_video_indices_conversion_and_dataset_match_jax(tmp_path):
    """``convert_video_dataset_to_indices`` through the port's codec (the
    JAX init loaded) writes the JAX package's memmap, in batches that do not
    divide the dataset; ``VideoIndicesDataset`` reads it back."""
    cfg = dict(dim=8, image_size=8, num_layers=2, vq_codebook_size=16, vq_codebook_dim=8,
               resnet_groups=4, use_vgg_and_gan=False, vq_kmeans_init=False, use_attn=False,
               num_resnet_blocks=0)
    jvae = JVAE(**cfg)
    params = jax.tree.map(np.asarray, jvae.init(jax.random.PRNGKey(0)))
    state = jax.tree.map(np.asarray, jvae.init_state(jax.random.PRNGKey(1)))
    tvae = load_vqgan_vae(VQGanVAE(**cfg, device="cpu"), params, state)
    videos = [(np.zeros(2), np.random.default_rng(i).uniform(size=(2, 3, 8, 8)).astype(
        np.float32)) for i in range(3)]
    for pkg, vae_kw in ((data, dict(vae=tvae)),
                        (jdata, dict(vae=jvae, vae_params=params, vae_state=state))):
        pkg.convert_video_dataset_to_indices(raw_video_dataset=videos, num_frames=2,
                                             path=tmp_path / f"{pkg.__name__}.i64",
                                             batch_size=2, **vae_kw)
    got, want = (np.fromfile(tmp_path / f"{pkg.__name__}.i64", dtype=np.int64)
                 for pkg in (data, jdata))
    assert got.shape == (3 * 2 * 4,)
    np.testing.assert_array_equal(got, want)
    _, t = _mnist_files(tmp_path)
    kw = dict(videos_memmap_path=tmp_path / f"{data.__name__}.i64", text_memmap_path=t,
              num_videos=3, num_frames=2)
    ours = data.VideoIndicesDataset(vae=tvae, **kw)
    theirs = jdata.VideoIndicesDataset(vae=jvae, **kw)
    for i in range(3):
        assert _same(ours[i], theirs[i])


def test_gif_helpers_and_gif_video_dataset_match_jax(tmp_path):
    """A gif written by each package reads the same in both; the reference's
    names are the same functions; the dataset pairs gifs with captions."""
    video = np.random.default_rng(3).uniform(size=(3, 1, 8, 8)).astype(np.float32)
    image.array_to_gif(video, tmp_path / "ours.gif")
    jimage.array_to_gif(video, tmp_path / "theirs.gif")
    for name in ("ours", "theirs"):
        for channels in (1, 3):
            got = image.gif_to_array(tmp_path / f"{name}.gif", channels=channels)
            assert _same(got, jimage.gif_to_array(tmp_path / f"{name}.gif", channels=channels))
            assert got.shape == (3, channels, 8, 8)
    assert _same(image.gif_to_array(tmp_path / "ours.gif", channels=1),
                 image.gif_to_array(tmp_path / "theirs.gif", channels=1))
    assert image.gif_to_tensor is image.gif_to_array
    assert image.video_tensor_to_gif is image.array_to_gif
    (tmp_path / "ours.txt").write_text("a red square")
    (tmp_path / "theirs.txt").write_text("moving on")
    ours, theirs = data.GifVideoDataset(folder=tmp_path), jdata.GifVideoDataset(folder=tmp_path)
    assert len(ours) == 2
    for i in range(2):
        assert _same(ours[i], theirs[i])


class _Items:
    def __init__(self, n, pairs=False):
        rng = np.random.default_rng(n)
        self.items = [rng.standard_normal((2, 3)).astype(np.float32) for _ in range(n)]
        if pairs:
            self.items = [(np.arange(3, dtype=np.int64) + i, x) for i, x in enumerate(self.items)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_gives_the_jax_batches_in_order(shuffle, drop_last):
    """Plain arrays over three epochs (7 items, batches of 3), stacked into
    windows of 2; (text, video) pairs of one text width, which the JAX
    package's default collate stacks and the port's pads to the same."""
    for pairs in (False, True):
        kw = dict(shuffle=shuffle, seed=6, drop_last=drop_last)
        ours = data.DataLoader(_Items(7, pairs), 3, **kw).cycle()
        theirs = jdata.DataLoader(_Items(7, pairs), 3, **kw).cycle()
        for _ in range(7 if drop_last else 9):
            assert _same(next(ours), next(theirs))
    kw = dict(shuffle=shuffle, seed=2, drop_last=drop_last)
    ours = data.stack_microbatches(data.DataLoader(_Items(8), 2, **kw).cycle(), 2)
    theirs = jdata.stack_microbatches(jdata.DataLoader(_Items(8), 2, **kw).cycle(), 2)
    for _ in range(5):
        got = next(ours)
        assert _same(got, next(theirs)) and got.shape == (2, 2, 2, 3)
    with pytest.raises(ValueError, match="no batches"):
        next(data.DataLoader(_Items(1), 2, **kw).cycle() if drop_last
             else data.DataLoader(_Items(0), 2, **kw).cycle())
