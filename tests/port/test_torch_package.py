"""The PyTorch port's package surface: no jax, same configs, same token ids.

Each module of ``tapclip_tpu_torch`` is held against its JAX counterpart in
``tapclip_tpu``; these are the pieces with no numerics beyond data: the
import boundary, the config dataclasses, the tokenizer and preprocessing.
"""

import dataclasses
import io
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import tapclip_tpu.config as jcfg
import tapclip_tpu.data.preprocess as jpre
from tapclip_tpu.data.tokenizer import SimpleTokenizer as JaxTokenizer

import tapclip_tpu_torch.config as tcfg
import tapclip_tpu_torch.data.preprocess as tpre
from tapclip_tpu_torch.data.tokenizer import SimpleTokenizer as TorchTokenizer

# One intra-op thread per process: the suite runs several workers on the
# machine's cores, and torch's default of a thread per core oversubscribes
# them (the plain versions' small operators then wait on each other).
torch.set_num_threads(1)

PORT_MODULES = [
    "tapclip_tpu_torch",
    "tapclip_tpu_torch.config",
    "tapclip_tpu_torch.data.tokenizer",
    "tapclip_tpu_torch.data.preprocess",
    "tapclip_tpu_torch.data.domains",
    "tapclip_tpu_torch.data.synthetic",
    "tapclip_tpu_torch.data.native",
    "tapclip_tpu_torch.data.prefetch",
    "tapclip_tpu_torch.data.imagefolder",
    "tapclip_tpu_torch.ops._build",
    "tapclip_tpu_torch.ops.attention",
    "tapclip_tpu_torch.ops.fused_mlp",
    "tapclip_tpu_torch.ops.fused_mha",
    "tapclip_tpu_torch.ops.flash_attention",
    "tapclip_tpu_torch.ops.gemm",
    "tapclip_tpu_torch.ops.int8_mlp",
    "tapclip_tpu_torch.ops.int8_attn",
    "tapclip_tpu_torch.ops.int8_gemm",
    "tapclip_tpu_torch.ops.fused_layer",
    "tapclip_tpu_torch.models.layers",
    "tapclip_tpu_torch.models.clip",
    "tapclip_tpu_torch.models.prompt_learner",
    "tapclip_tpu_torch.models.attribution_monitor",
    "tapclip_tpu_torch.models.prompt_adjustor",
    "tapclip_tpu_torch.models.model_wrapper",
    "tapclip_tpu_torch.models.clip_wrapper",
    "tapclip_tpu_torch.models.resnet",
    "tapclip_tpu_torch.utils.jax_bridge",
    "tapclip_tpu_torch.utils.logging_utils",
    "tapclip_tpu_torch.utils.adaptive_eval",
    "tapclip_tpu_torch.utils.torch_convert",
    "tapclip_tpu_torch.utils.checkpoint",
    "tapclip_tpu_torch.utils.eval_metrics",
    "tapclip_tpu_torch.utils.plotting",
    "tapclip_tpu_torch.utils.calibration",
    "tapclip_tpu_torch.parallel.train_step",
    "tapclip_tpu_torch.trainer",
    "tapclip_tpu_torch.serve",
    "tapclip_tpu_torch.train",
    "tapclip_tpu_torch.test_cross_domain",
    "tapclip_tpu_torch.test_cross_domain2",
    "tapclip_tpu_torch.featurize",
    "tapclip_tpu_torch.zero_shot",
    "tapclip_tpu_torch.data.shards",
    "tapclip_tpu_torch.search",
    "tapclip_tpu_torch.predict",
    "tapclip_tpu_torch.utils.saliency",
    "tapclip_tpu_torch.utils.corruptions",
    "tapclip_tpu_torch.robustness",
    "tapclip_tpu_torch.zero_shot_eval",
    "tapclip_tpu_torch.sweep",
    "tapclip_tpu_torch.scripts.int8_mlp_ab",
    "tapclip_tpu_torch.scripts.int8_probe",
    "tapclip_tpu_torch.scripts._bench_util",
    "tapclip_tpu_torch.scripts.fused_layer_ab",
    "tapclip_tpu_torch.scripts.mlp_kernel_ab",
    "tapclip_tpu_torch.scripts.attn_kernel_ab",
    "tapclip_tpu_torch.scripts.attn_softmax_ab",
    "tapclip_tpu_torch.scripts.time_half_blocks",
    "tapclip_tpu_torch.data.augment",
    "tapclip_tpu_torch.promptsrc",
    "tapclip_tpu_torch.maple",
    "tapclip_tpu_torch.tpt",
    "tapclip_tpu_torch.linear_probe",
    "tapclip_tpu_torch.tip_adapter",
    "tapclip_tpu_torch.clip_adapter",
    "tapclip_tpu_torch.base_to_new",
    "tapclip_tpu_torch.fewshot",
    "tapclip_tpu_torch.pretrain",
    "tapclip_tpu_torch.peft",
    "tapclip_tpu_torch.distill",
    "tapclip_tpu_torch.data.csv_dataset",
    "tapclip_tpu_torch.pretrain_cli",
    "tapclip_tpu_torch.ops._library",
    "tapclip_tpu_torch.ops.plain",
    "tapclip_tpu_torch.utils.model_export",
    "tapclip_tpu_torch.scripts.export_model",
    "tapclip_tpu_torch.scripts.convert_checkpoint",
    "tapclip_tpu_torch.scripts.ckpt_info",
    "tapclip_tpu_torch.scripts.model_soup",
    "tapclip_tpu_torch.examples.quickstart",
]


def test_port_never_imports_jax():
    """In a fresh interpreter (this one has jax already), importing every
    module of the port leaves jax and the JAX package out of sys.modules."""
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'tapclip_tpu.')) "
        "or m == 'tapclip_tpu')\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_import_serve_alone_leaves_jax_out():
    code = ("import tapclip_tpu_torch.zero_shot, tapclip_tpu_torch.featurize, tapclip_tpu_torch.serve, sys\n"
            "assert not [m for m in sys.modules if m == 'jax' or m.split('.')[0] == 'tapclip_tpu']\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@pytest.mark.parametrize("name", sorted(jcfg.MODEL_PRESETS))
def test_model_presets_equal(name):
    j, t = jcfg.MODEL_PRESETS[name], tcfg.MODEL_PRESETS[name]
    assert [f.name for f in dataclasses.fields(j)] == [f.name for f in dataclasses.fields(t)]
    assert _fields(j) == _fields(t)
    assert (j.grid_size, j.num_patches, j.vision_seq_len) == (t.grid_size, t.num_patches, t.vision_seq_len)


@pytest.mark.parametrize("cls", ["CLIPConfig", "PromptConfig", "TrainConfig", "MeshConfig"])
def test_config_defaults_equal(cls):
    j, t = getattr(jcfg, cls)(), getattr(tcfg, cls)()
    assert [f.name for f in dataclasses.fields(j)] == [f.name for f in dataclasses.fields(t)]
    assert _fields(j) == _fields(t)


@pytest.mark.parametrize(
    "name", ["tiny", "zeroshot_b32", "fewshot16_b16", "domainnet", "vitl_unseen", "reference_train"]
)
def test_experiment_presets_equal(name):
    j, t = jcfg.preset(name), tcfg.preset(name)
    assert repr(dataclasses.asdict(j)) == repr(dataclasses.asdict(t))


def test_named_presets_and_constants():
    assert tcfg.IMAGE_MEAN == jcfg.IMAGE_MEAN and tcfg.IMAGE_STD == jcfg.IMAGE_STD
    assert _fields(tcfg.VIT_B_16) == _fields(jcfg.VIT_B_16)
    assert _fields(tcfg.VIT_B_32) == _fields(jcfg.VIT_B_32)
    assert _fields(tcfg.TINY_TEST) == _fields(jcfg.TINY_TEST)
    with pytest.raises(KeyError):
        tcfg.preset("nope")


@pytest.mark.parametrize("dtype,expected", [("float32", torch.float32), ("bfloat16", torch.bfloat16)])
def test_compute_dtype_maps_to_torch(dtype, expected):
    assert tcfg.VIT_B_16.replace(dtype=dtype).compute_dtype == expected


TEXTS = [
    "a photo of a Backpack",
    "a photo of a Alarm_Clock",
    "a photo of a Clipboards",
    "Mug",
    "a photo of a Bottle, with   extra   spaces!",
    "héllo wörld &amp; 42 cats's",
    "a very long prompt " * 20,
]


@pytest.mark.parametrize("context_length", [16, 77])
def test_tokenizer_fallback_ids_equal(context_length):
    j, t = JaxTokenizer(), TorchTokenizer()
    assert j.is_fallback and t.is_fallback
    np.testing.assert_array_equal(j.tokenize(TEXTS, context_length), t.tokenize(TEXTS, context_length))
    assert t.tokenize(TEXTS, context_length).dtype == np.int32
    assert j.decode(j.encode(TEXTS[0])) == t.decode(t.encode(TEXTS[0]))


def test_tokenizer_bpe_merges_ids_equal(tmp_path):
    """With a merges file both tokenizers apply the same BPE merges."""
    merges = ["#version: 0.2", "a </w>", "p h", "ph o", "pho t", "o </w>", "t o", "c l", "cl i"]
    path = tmp_path / "merges.txt"
    path.write_text("\n".join(merges) + "\n")
    j, t = JaxTokenizer(bpe_path=str(path)), TorchTokenizer(bpe_path=str(path))
    assert not t.is_fallback
    np.testing.assert_array_equal(j.tokenize(TEXTS, 77), t.tokenize(TEXTS, 77))
    assert j.vocab_size == t.vocab_size


def test_preprocess_host_side_equal():
    rng = np.random.default_rng(0)
    img = Image.fromarray(rng.integers(0, 256, (40, 57, 3), dtype=np.uint8))
    np.testing.assert_array_equal(jpre.preprocess_pil(img, 32), tpre.preprocess_pil(img, 32))
    np.testing.assert_array_equal(jpre.preprocess_pil_uint8(img, 32), tpre.preprocess_pil_uint8(img, 32))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    buf.seek(0)
    np.testing.assert_array_equal(
        jpre.make_preprocess(24)(Image.open(buf)), tpre.make_preprocess(24)(Image.open(buf))
    )
    arr = rng.random((4, 4, 3)).astype(np.float32)
    np.testing.assert_array_equal(jpre.normalize(arr), tpre.normalize(arr))


def test_device_normalize_bit_compatible():
    import jax.numpy as jnp

    px = np.random.default_rng(1).integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    want = np.asarray(jpre.device_normalize(jnp.asarray(px)))
    got = tpre.device_normalize(torch.from_numpy(px)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
