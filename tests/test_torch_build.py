"""The CUDA build's library names (``nuwa_tpu_torch/kernels/build.py``): a
library is named by the hash of its source and of every ``csrc`` header, so
an edited header never loads a stale library. Pure Python: nothing is
compiled."""
from nuwa_tpu_torch.kernels import build


def test_every_sparse3dna_source_includes_the_one_geometry_header():
    for name in ("sparse3dna_fwd", "sparse3dna_bwd_q", "sparse3dna_bwd_kv"):
        source = (build.CSRC / f"{name}.cu").read_text()
        assert '#include "sparse3dna_geometry.cuh"' in source, name
        assert "struct Geometry" not in source and "int neighbour(" not in source, name


def test_library_name_follows_the_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "a.cuh"\nint x;\n')
    (tmp_path / "a.cuh").write_text("#pragma once\n")
    names = [build._target("k").name]
    (tmp_path / "a.cuh").write_text("#pragma once\n// edited\n")
    names.append(build._target("k").name)
    (tmp_path / "k.cu").write_text('#include "a.cuh"\nint y;\n')
    names.append(build._target("k").name)
    assert len(set(names)) == 3
    assert all(n.startswith("libk-") and n.endswith(".so") for n in names)



def test_the_dropout_sources_include_the_one_hash_header(tmp_path, monkeypatch):
    """The forward and the query-side kernel draw their dropout mask from one
    hash in ``sparse3dna_dropout.cuh``, and an edit of that header renames
    every Sparse3DNA library; the key side needs no mask (it reads the
    dropped mix)."""
    for name in ("sparse3dna_fwd", "sparse3dna_bwd_q"):
        source = (build.CSRC / f"{name}.cu").read_text()
        assert '#include "sparse3dna_dropout.cuh"' in source, name
        assert "0x7FEB352D" not in source, name  # the hash lives in the header only
    names = ("sparse3dna_fwd", "sparse3dna_bwd_q", "sparse3dna_bwd_kv")
    for path in build.CSRC.iterdir():
        (tmp_path / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = [build._target(name).name for name in names]
    header = tmp_path / "sparse3dna_dropout.cuh"
    header.write_text(header.read_text() + "// edited\n")
    after = [build._target(name).name for name in names]
    assert all(a != b for a, b in zip(before, after))


def test_the_cross_dropout_sources_include_the_one_hash_header(tmp_path, monkeypatch):
    """The SparseCross2DNA forward and query-side kernel draw their dropout
    mask from the same hash header as the Sparse3DNA kernels, and an edit
    of that header renames every cross library."""
    for name in ("sparse_cross2dna_fwd", "sparse_cross2dna_bwd_q"):
        source = (build.CSRC / f"{name}.cu").read_text()
        assert '#include "sparse3dna_dropout.cuh"' in source, name
        assert "0x7FEB352D" not in source, name  # the hash lives in the header only
    names = ("sparse_cross2dna_fwd", "sparse_cross2dna_bwd_q", "sparse_cross2dna_bwd_kv")
    for path in build.CSRC.iterdir():
        (tmp_path / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = [build._target(name).name for name in names]
    header = tmp_path / "sparse3dna_dropout.cuh"
    header.write_text(header.read_text() + "// edited\n")
    after = [build._target(name).name for name in names]
    assert all(a != b for a, b in zip(before, after))
