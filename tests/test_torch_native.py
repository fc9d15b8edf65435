"""Port parity: the batch loader (``nuwa_tpu_torch/native``), the port's own
g++ library, against ``nuwa_tpu.native`` (which imports numpy only) and
against the port's numpy versions (``*_plain``), bit for bit.

The library is built here with g++, as on the card. The port has no numpy
fallback: a failed build raises, and the memmap dataset raises with it.
Indices are checked on the host as numpy checks them.
"""
import numpy as np
import pytest

from nuwa_tpu import native as jnative
from nuwa_tpu_torch import native
from nuwa_tpu_torch.native import loader
from nuwa_tpu_torch.train import data


def _memmap(path, shape, seed):
    mm = np.memmap(path, mode="w+", dtype=np.uint8, shape=shape)
    mm[:] = np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)
    mm.flush()
    return np.memmap(path, mode="r", dtype=np.uint8, shape=shape)


def _equal(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def memmaps(tmp_path_factory):
    """The codec trainer's memmap at the README's image size (64 frames of
    3 x 256 x 256), a small one, and one of 2-D items."""
    folder = tmp_path_factory.mktemp("native")
    return {shape: _memmap(folder / f"{i}.u8", shape, i)
            for i, shape in enumerate([(64, 3, 256, 256), (20, 3, 8, 8), (10, 8, 8)])}


def test_the_library_builds_into_the_ignored_build_directory():
    path = native.build_library()
    assert native.library_available()
    assert path == str(loader.library_path())
    assert loader.library_path().parent == loader.BUILD_DIR
    assert loader.SOURCE.parent == loader.BUILD_DIR.parent


@pytest.mark.parametrize("num_threads", [1, 2, 8])
@pytest.mark.parametrize("shape, batch", [((64, 3, 256, 256), 32), ((20, 3, 8, 8), 7),
                                          ((10, 8, 8), 5)])
def test_gather_normalize_matches_jax_and_plain(memmaps, shape, batch, num_threads):
    src = memmaps[shape]
    idx = np.random.default_rng(batch).integers(0, shape[0], size=batch)
    got = native.gather_normalize_f32(src, idx, num_threads=num_threads)
    _equal(got, jnative.gather_normalize_f32(src, idx, num_threads=num_threads))
    _equal(got, loader.gather_normalize_f32_plain(src, idx))
    assert got.shape == (batch,) + shape[1:]


@pytest.mark.parametrize("shape", [(3, 4, 6), (1, 5, 5), (2, 70, 45)])
@pytest.mark.parametrize("k", range(-1, 5))
def test_rot90_matches_jax_and_plain(shape, k):
    """Small planes and one that the odd k's 32 x 32 tiles cut raggedly."""
    img = np.random.default_rng(k + 1).uniform(size=shape).astype(np.float32)
    got = native.rot90_f32(img, k)
    _equal(got, jnative.rot90_f32(img, k))
    _equal(got, loader.rot90_f32_plain(img, k))


def test_gather_i64_matches_jax_and_plain():
    src = np.random.default_rng(0).integers(-2**40, 2**40, size=(10, 3, 4), dtype=np.int64)
    idx = np.array([9, 2, 2, 0, 9, 9])
    got = native.gather_i64(src, idx)
    _equal(got, jnative.gather_i64(src, idx))
    _equal(got, loader.gather_i64_plain(src, idx))


@pytest.mark.parametrize("fn, dtype", [(native.gather_normalize_f32, np.uint8),
                                       (native.gather_i64, np.int64)])
def test_indices_are_checked_as_numpy_checks_them(fn, dtype):
    """-1 wraps to the last row, as numpy (and JAX's numpy path) reads it;
    N and -N-1 raise IndexError before the library is called."""
    src = np.arange(6 * 4, dtype=dtype).reshape(6, 2, 2)
    plain = {np.uint8: loader.gather_normalize_f32_plain,
             np.int64: loader.gather_i64_plain}[dtype]
    _equal(fn(src, np.array([-1, 0, -6])), plain(src, np.array([-1, 0, -6])))
    for bad in (6, -7):
        with pytest.raises(IndexError):
            plain(src, np.array([0, bad]))
        with pytest.raises(IndexError, match=f"index {bad} is out of bounds"):
            fn(src, np.array([0, bad]))
    with pytest.raises(TypeError):
        fn(src.astype(np.float32), np.array([0]))


@pytest.mark.parametrize("fault", ["missing compiler", "broken source"])
def test_a_failed_build_raises_everywhere(tmp_path, monkeypatch, fault):
    """No numpy fallback: the build raises with the compiler's output,
    ``library_available()`` says False, and the memmap dataset's read
    raises rather than answering from numpy."""
    monkeypatch.setattr(loader, "_lib", None)
    monkeypatch.setattr(loader, "BUILD_DIR", tmp_path / "build")
    if fault == "missing compiler":
        monkeypatch.setattr(loader, "CXX", str(tmp_path / "no-such-g++"))
        match = "no-such-g\\+\\+"
    else:
        broken = tmp_path / "batch_loader.cpp"
        broken.write_text(loader.SOURCE.read_text() + "\nint broken = ;\n")
        monkeypatch.setattr(loader, "SOURCE", broken)
        match = "error"
    with pytest.raises(RuntimeError, match=match):
        native.build_library()
    assert not native.library_available()
    assert not (tmp_path / "build").exists() or not list((tmp_path / "build").glob("*.so"))
    shape = (2, 3, 4, 4)
    _memmap(tmp_path / "imgs.u8", shape, 0)
    ds = data.MemmappedImageDataset(path=tmp_path / "imgs.u8", shape=shape, seed=0)
    with pytest.raises(RuntimeError, match=match):
        ds[0]
    with pytest.raises(RuntimeError):
        native.gather_i64(np.zeros((2, 1), np.int64), [0])


def test_the_library_name_follows_the_source(tmp_path, monkeypatch):
    """Named by the hash of the source's bytes (the CUDA kernels' rule):
    the same bytes elsewhere give the same name, one more byte another."""
    names = [loader.library_path().name]
    copy = tmp_path / "batch_loader.cpp"
    copy.write_bytes(loader.SOURCE.read_bytes())
    monkeypatch.setattr(loader, "SOURCE", copy)
    names.append(loader.library_path().name)
    copy.write_bytes(copy.read_bytes() + b"\n")
    names.append(loader.library_path().name)
    assert names[0] == names[1] != names[2]
    assert all(n.startswith("libbatch_loader-") and n.endswith(".so") for n in names)
