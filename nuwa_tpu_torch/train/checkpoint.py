"""Checkpoints in the JAX package's version-2 format, with atomic writes.

Counterpart of ``nuwa_tpu/train/checkpoint.py`` with ``numpy``, ``zipfile``
and ``torch`` only. A checkpoint is an uncompressed zip of one
``leaf_%06d.npy`` per leaf of a nested dict / list tree and a
``manifest.json`` holding ``keys`` (each leaf's path, written as
``jax.tree_util.keystr`` writes it: ``['params']['layers'][0]['w']``, dict
keys in sorted order), ``dtypes`` and ``"version": 2``. Leaves are written
one at a time, so no second copy of a whole train state is made; a
bfloat16 leaf is stored as its same-width ``uint16`` bits with the name
``bfloat16`` in the manifest, and read back to ``torch.bfloat16`` through
those bits, so neither ``ml_dtypes`` nor ``flax`` is needed. Each write
goes to a temp file in the same folder, then an atomic rename, then
``<name>.LATEST`` names the file the same way; ``latest_checkpoint`` falls
back to a scan of the folder when LATEST is missing or stale.

The JAX package's files (its ``NUWATrainer``'s among them) read with
``load_checkpoint``; the legacy flax-msgpack files of its rounds 1-4 do not
(they need flax). ``save_checkpoint`` takes torch tensors, numpy arrays and
Python scalars, ``load_checkpoint`` gives torch tensors on the CPU.
"""
from __future__ import annotations

import io
import json
import os
import re
import tempfile
import zipfile
from pathlib import Path

import numpy as np
import torch

_UINT_OF_WIDTH = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}
# dtypes numpy cannot hold, stored as their bits: name -> (torch dtype, signed
# torch and numpy types of their width)
_BITS = {"bfloat16": (torch.bfloat16, torch.int16, np.int16)}


class CheckpointMismatchError(ValueError):
    """A checkpoint's leaves are not those its reader expects."""


class Attr(str):
    """A path part that is an attribute (a field of one of optax's named
    tuples, such as ``ScaleByAdamState.mu``): ``keystr`` writes it
    ``.mu``."""


def keystr(path) -> str:
    """A leaf's path (dict keys, list indices and ``Attr`` fields) as
    ``jax.tree_util.keystr`` writes it."""
    return "".join(f".{p}" if isinstance(p, Attr) else f"[{p}]" if isinstance(p, int)
                   else f"[{str(p)!r}]" for p in path)


_PART = re.compile(r"\['((?:[^'\\]|\\.)*)'\]|\[(\d+)\]|\.(\w+)")


def parse_keystr(key: str) -> tuple:
    """The parts of a ``keystr`` path: dict keys as strings, attribute
    names as ``Attr``, list indices as ints."""
    parts, end = [], 0
    for m in _PART.finditer(key):
        if m.start() != end:
            raise ValueError(f"not a key path: {key!r}")
        name, index, attr = m.groups()
        parts.append(int(index) if index is not None else (name if name is not None else Attr(attr)))
        end = m.end()
    if end != len(key):
        raise ValueError(f"not a key path: {key!r}")
    return tuple(parts)


def flatten(tree, path=()):
    """[(path, leaf)] of a nested dict / list tree, dict keys sorted as JAX
    flattens them."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in flatten(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree) for item in flatten(v, path + (i,))]
    return [(path, tree)]


def _dtype_name(leaf):
    if torch.is_tensor(leaf):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def _array(leaf):
    """The numpy array to write: a bfloat16 tensor's bits as uint16."""
    if not torch.is_tensor(leaf):
        return np.asarray(leaf)
    t = leaf.detach().cpu()
    name = _dtype_name(t)
    if name in _BITS:
        return t.view(_BITS[name][1]).numpy().view(_UINT_OF_WIDTH[t.element_size()])
    return t.numpy()


def _atomic_write(directory: Path, final: Path, writer):
    fd, tmp = tempfile.mkstemp(dir=str(directory), suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            writer(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save_checkpoint(directory, name, step, tree):
    """Atomically write ``<directory>/<name>.<step>.ckpt`` and update
    ``<name>.LATEST``; returns the file's path."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"{name}.{step}.ckpt"
    items = flatten(tree)

    def write(f):
        with zipfile.ZipFile(f, "w", zipfile.ZIP_STORED) as zf:
            manifest = {"keys": [keystr(p) for p, _ in items],
                        "dtypes": [_dtype_name(leaf) for _, leaf in items], "version": 2}
            zf.writestr("manifest.json", json.dumps(manifest))
            for i, (_, leaf) in enumerate(items):  # one leaf on the host at a time
                buf = io.BytesIO()
                np.lib.format.write_array(buf, _array(leaf), allow_pickle=False)
                zf.writestr(f"leaf_{i:06d}.npy", buf.getvalue())

    _atomic_write(directory, final, write)
    payload = json.dumps({"step": step, "file": final.name}).encode()
    _atomic_write(directory, directory / f"{name}.LATEST", lambda f: f.write(payload))
    return str(final)


def latest_checkpoint(directory, name):
    """(step, path) of the newest checkpoint, or None: LATEST's file when it
    exists, else the highest step of a scan of the folder."""
    directory = Path(directory)
    meta = directory / f"{name}.LATEST"
    if meta.exists():
        info = json.loads(meta.read_text())
        path = directory / info["file"]
        if path.exists():
            return info["step"], str(path)
    best = None
    pat = re.compile(rf"^{re.escape(name)}\.(\d+)\.ckpt$")
    if directory.exists():
        for f in directory.iterdir():
            m = pat.match(f.name)
            if m and (best is None or int(m.group(1)) > best[0]):
                best = (int(m.group(1)), str(f))
    return best


def _tensor(arr, dtype):
    """A read leaf as a tensor of its true dtype (wider unsigned ints, which
    torch barely holds, as int64)."""
    arr = np.require(arr, requirements="C")  # keeps a 0-d leaf 0-d
    if dtype in _BITS:
        torch_dtype, _, signed = _BITS[dtype]
        return torch.from_numpy(arr.view(signed)).view(torch_dtype)
    arr = arr.astype(np.dtype(dtype), copy=False)
    if arr.dtype.kind == "u" and arr.itemsize > 1:
        arr = arr.astype(np.int64)
    return torch.from_numpy(arr)


def load_checkpoint(path, keys=None) -> dict:
    """{key path: CPU tensor} of a version-2 checkpoint, in the file's order,
    each leaf in its saved dtype (bfloat16 rebuilt from its bits). With
    ``keys`` (an iterable of key paths), the file must hold exactly those
    leaves, else ``CheckpointMismatchError``."""
    with zipfile.ZipFile(str(path), "r") as zf:
        manifest = json.loads(zf.read("manifest.json"))
        saved = manifest["keys"]
        if keys is not None and sorted(saved) != sorted(keys := list(keys)):
            missing = sorted(set(keys) - set(saved))[:5]
            unused = sorted(set(saved) - set(keys))[:5]
            raise CheckpointMismatchError(
                f"checkpoint {path} does not match: {len(saved)} saved leaves against "
                f"{len(keys)} expected; missing e.g. {missing}, unexpected e.g. {unused}")
        dtypes = manifest.get("dtypes") or [None] * len(saved)  # absent in version 1
        out = {}
        for i, (key, dtype) in enumerate(zip(saved, dtypes)):
            with zf.open(f"leaf_{i:06d}.npy") as f:
                arr = np.lib.format.read_array(f, allow_pickle=False)
            out[key] = _tensor(arr, dtype or str(arr.dtype))
    return out


def restore_latest(directory, name, keys=None):
    """(step, ``load_checkpoint``'s leaves) of the newest checkpoint, or
    None when there is none."""
    found = latest_checkpoint(directory, name)
    if found is None:
        return None
    step, path = found
    return step, load_checkpoint(path, keys)


def unflatten(leaves: dict):
    """A nested dict / list tree of ``{key path: leaf}``: the inverse of
    ``flatten`` for trees of dicts and lists."""
    return tree_of({parse_keystr(key): leaf for key, leaf in leaves.items()})


def tree_of(items: dict):
    """A nested dict / list tree of ``{path tuple: leaf}``, a node whose keys
    are all ints becoming a list."""
    root = {}
    for parts, leaf in items.items():
        node = root
        for part, nxt in zip(parts, parts[1:]):
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(isinstance(k, int) for k in node):
            return [node[i] for i in range(len(node))]
        return node

    return lists(root)
