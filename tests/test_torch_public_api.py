"""The port's public surface mirrors tests/test_public_api.py and each
subpackage's ``__all__`` of nuwa_tpu, and the port imports neither JAX nor
nuwa_tpu."""
import ast
import importlib
import math
from pathlib import Path

import pytest

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


def _exports(path):
    """The names of a module's ``__all__``, read from its source (nothing
    imported)."""
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return [ast.literal_eval(e) for e in node.value.elts]
    raise AssertionError(f"{path} has no __all__")


@pytest.mark.parametrize("package", ["models", "native", "ops", "parallel", "train"])
def test_every_subpackage_export_of_nuwa_tpu_is_the_ports(package):
    """Every name of each subpackage's ``__all__`` (read by AST, so JAX is
    not imported) is in the port counterpart's ``__all__`` and imports from
    it."""
    names = _exports(REPO / "nuwa_tpu" / package / "__init__.py")
    ported = importlib.import_module(f"nuwa_tpu_torch.{package}")
    assert names and set(names) <= set(ported.__all__), set(names) - set(ported.__all__)
    for name in names:
        assert getattr(ported, name) is not None, name


def test_trainable_mask_matches_jax_on_nuwa_sketch():
    """The port's mask (over ``named_parameters``) is False exactly under
    ``vae`` and ``sketch_vae``, agrees with ``requires_grad``, and counts
    the JAX mask's frozen and trainable elements over the same model's
    ``jax.eval_shape`` params, whose codec ``state`` subtrees are the port's
    buffers."""
    import jax

    from nuwa_tpu.models import NUWASketch as JNUWASketch
    from nuwa_tpu.train import trainable_mask as jax_trainable_mask
    from nuwa_tpu.vqgan_vae import VQGanVAE as JVQGanVAE
    from nuwa_tpu_torch import NUWASketch, VQGanVAE
    from nuwa_tpu_torch.train import trainable_mask

    vae = dict(dim=8, image_size=8, num_layers=1, vq_codebook_size=16, vq_codebook_dim=8,
               resnet_groups=4, use_vgg_and_gan=False, vq_kmeans_init=False, use_attn=False,
               num_resnet_blocks=0)
    cfg = dict(dim=32, image_size=8, max_video_frames=2, sketch_max_video_frames=2,
               sketch_enc_depth=1, dec_depth=1, dec_heads=2, dec_dim_head=8,
               sketch_enc_heads=2, sketch_enc_dim_head=8)
    model = NUWASketch(vae=VQGanVAE(**vae, device="cpu"),
                       sketch_vae=VQGanVAE(**vae, channels=5, device="cpu"), **cfg, device="cpu")
    mask = trainable_mask(model)
    params = dict(model.named_parameters())
    assert list(mask) == list(params)
    for name, trainable in mask.items():
        assert trainable == (name.split(".")[0] not in ("vae", "sketch_vae")), name
        assert trainable == params[name].requires_grad, name
    frozen = sum(params[n].numel() for n, t in mask.items() if not t)
    trained = sum(params[n].numel() for n, t in mask.items() if t)
    buffers = sum(b.numel() for n, b in model.named_buffers()
                  if n.split(".")[0] in ("vae", "sketch_vae"))
    assert frozen and trained and buffers

    jmodel = JNUWASketch(vae=JVQGanVAE(**vae), sketch_vae=JVQGanVAE(**vae, channels=5), **cfg)
    key = jax.random.PRNGKey(0)

    def init():  # traced only
        codecs = {}
        for name in ("vae", "sketch_vae"):
            codec = getattr(jmodel, name)
            codecs.update({f"{name}_params": codec.init(key),
                           f"{name}_state": codec.init_state(key)})
        return jmodel.init(key, **codecs)

    shapes = jax.eval_shape(init)
    counts = {True: 0, False: 0}
    for leaf, trainable in zip(jax.tree.leaves(shapes),
                               jax.tree.leaves(jax_trainable_mask(shapes))):
        counts[trainable] += math.prod(leaf.shape)
    state = sum(math.prod(leaf.shape) for name in ("vae", "sketch_vae")
                for leaf in jax.tree.leaves(shapes[name]["state"]))
    assert state == buffers
    assert counts == {True: trained, False: frozen + buffers}
