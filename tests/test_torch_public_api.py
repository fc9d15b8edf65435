"""The port's public surface mirrors tests/test_public_api.py for the names
ported so far, and imports neither JAX nor nuwa_tpu."""
import ast
from pathlib import Path

import nuwa_tpu_torch

REPO = Path(__file__).resolve().parents[1]
PORTED = ("NUWA", "NUWASketch", "NUWAVideoAudio", "Sparse3DNA", "SparseCausal2DNA",
          "CrossModalityCrossAttention", "VQGanVAE", "NUWATrainer", "VQGanVAETrainer")
EXTRAS = ("Attention", "SparseCross2DNA")
NOT_YET = ()


def test_public_exports():
    for name in PORTED + EXTRAS:
        assert getattr(nuwa_tpu_torch, name) is not None, name
        assert name in nuwa_tpu_torch.__all__
    assert nuwa_tpu_torch.tokenizer.vocab_size == 49408
    for name in NOT_YET:
        assert not hasattr(nuwa_tpu_torch, name), name


def test_exports_are_the_modules_classes():
    from nuwa_tpu_torch.models.nuwa import NUWA
    from nuwa_tpu_torch.models.nuwa_video_audio import NUWAVideoAudio
    from nuwa_tpu_torch.nda import Sparse3DNA, SparseCausal2DNA, SparseCross2DNA
    from nuwa_tpu_torch.ops.attention import Attention
    from nuwa_tpu_torch.ops.crossmodality import CrossModalityCrossAttention
    from nuwa_tpu_torch.tokenizer import SimpleTokenizer
    from nuwa_tpu_torch.train.trainer_nuwa import NUWATrainer
    from nuwa_tpu_torch.train.trainer_vqgan import VQGanVAETrainer

    assert nuwa_tpu_torch.NUWA is NUWA
    assert nuwa_tpu_torch.Sparse3DNA is Sparse3DNA
    assert nuwa_tpu_torch.SparseCross2DNA is SparseCross2DNA
    assert nuwa_tpu_torch.NUWAVideoAudio is NUWAVideoAudio
    assert nuwa_tpu_torch.SparseCausal2DNA is SparseCausal2DNA
    assert nuwa_tpu_torch.CrossModalityCrossAttention is CrossModalityCrossAttention
    assert nuwa_tpu_torch.Attention is Attention
    assert nuwa_tpu_torch.NUWATrainer is NUWATrainer
    assert nuwa_tpu_torch.VQGanVAETrainer is VQGanVAETrainer
    assert isinstance(nuwa_tpu_torch.tokenizer, SimpleTokenizer)


def test_no_module_of_the_port_imports_jax_or_the_jax_package():
    files = sorted((REPO / "nuwa_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    for module in ("dual_decoder", "decode_dual", "reversible_dual", "ops/crossmodality",
                   "models/nuwa_video_audio"):
        assert REPO / "nuwa_tpu_torch" / f"{module}.py" in files
    for path in files:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "nuwa_tpu"), (path, name)
