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
