"""Configuration for tapclip_tpu_torch.

A copy of ``tapclip_tpu/config.py`` without its JAX import: the fields,
defaults and presets are the same (a test holds every field equal), and
``CLIPConfig.compute_dtype`` returns a ``torch.dtype``.  The copy exists
because importing anything from ``tapclip_tpu`` imports jax.

``attn_impl`` keeps the JAX package's values so configs compare equal:
``"auto"`` routes every block through the kernel wrappers (which launch the
hand-written CUDA kernels on a CUDA tensor and run their plain PyTorch
versions on a CPU tensor), and ``"xla"`` runs the plain PyTorch
composition everywhere, as ``attn_impl="xla"`` runs the plain XLA
composition in the JAX package.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

# CLIP preprocessing constants (OpenAI CLIP / open_clip defaults).
IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class CLIPConfig:
    """Architecture of a CLIP two-tower model (fields as in the JAX package)."""

    name: str = "ViT-B-32"
    vision_tower: str = "vit"
    image_size: int = 224
    patch_size: int = 32
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    resnet_layers: tuple = ()
    vocab_size: int = 49408
    context_length: int = 77
    text_width: int = 512
    text_layers: int = 12
    text_heads: int = 8
    embed_dim: int = 512
    mlp_ratio: int = 4
    act: str = "gelu"
    ln_eps: float = 1e-5
    dtype: str = "float32"
    attn_impl: str = "auto"
    token_keep_ratio: float = 1.0
    token_prune_layer: int = 4
    quantize_tower: bool = False
    int8_deterministic: bool = False
    remat: str = "none"
    scan_unroll: int = 1
    moe_experts: int = 0
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    patch_dropout: float = 0.0
    vpt_tokens: int = 0
    vpt_deep: bool = False

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size * self.grid_size

    @property
    def vision_seq_len(self) -> int:
        return self.num_patches + 1  # + class token

    @property
    def compute_dtype(self) -> torch.dtype:
        if self.dtype not in _DTYPES:
            raise ValueError(f"unsupported dtype {self.dtype!r}; one of {sorted(_DTYPES)}")
        return _DTYPES[self.dtype]

    def replace(self, **kw) -> "CLIPConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Model presets
# ---------------------------------------------------------------------------

VIT_B_32 = CLIPConfig(name="ViT-B-32")
VIT_B_16 = CLIPConfig(name="ViT-B-16", patch_size=16)
VIT_L_14 = CLIPConfig(
    name="ViT-L-14",
    patch_size=14,
    vision_width=1024,
    vision_layers=24,
    vision_heads=16,
    text_width=768,
    text_layers=12,
    text_heads=12,
    embed_dim=768,
)
VIT_L_14_336 = VIT_L_14.replace(name="ViT-L-14-336", image_size=336)

RN50 = CLIPConfig(
    name="RN50",
    vision_tower="resnet",
    vision_width=64,
    resnet_layers=(3, 4, 6, 3),
    embed_dim=1024,
)
RN101 = CLIPConfig(
    name="RN101",
    vision_tower="resnet",
    vision_width=64,
    resnet_layers=(3, 4, 23, 3),
    embed_dim=512,
)
RN50x4 = CLIPConfig(
    name="RN50x4",
    vision_tower="resnet",
    vision_width=80,
    resnet_layers=(4, 6, 10, 6),
    image_size=288,
    embed_dim=640,
    text_width=640,
    text_heads=10,
)
RN50x16 = CLIPConfig(
    name="RN50x16",
    vision_tower="resnet",
    vision_width=96,
    resnet_layers=(6, 8, 18, 8),
    image_size=384,
    embed_dim=768,
    text_width=768,
    text_heads=12,
)
RN50x64 = CLIPConfig(
    name="RN50x64",
    vision_tower="resnet",
    vision_width=128,
    resnet_layers=(3, 15, 36, 10),
    image_size=448,
    embed_dim=1024,
    text_width=1024,
    text_heads=16,
)

# A tiny config for unit tests.
TINY_TEST = CLIPConfig(
    name="tiny-test",
    image_size=32,
    patch_size=16,
    vision_width=64,
    vision_layers=2,
    vision_heads=4,
    # >= the byte-level fallback tokenizer's 514-entry vocab.
    vocab_size=520,
    context_length=16,
    text_width=64,
    text_layers=2,
    text_heads=4,
    embed_dim=32,
)

MODEL_PRESETS = {
    "ViT-B-32": VIT_B_32,
    "ViT-B-16": VIT_B_16,
    "ViT-L-14": VIT_L_14,
    "ViT-L-14-336": VIT_L_14_336,
    "RN50": RN50,
    "RN101": RN101,
    "RN50x4": RN50x4,
    "RN50x16": RN50x16,
    "RN50x64": RN50x64,
    "tiny-test": TINY_TEST,
}


@dataclass(frozen=True)
class PromptConfig:
    """Prompt-tuning configuration (fields as in the JAX package)."""

    prompt_len: int = 5
    class_specific: bool = True
    use_init_prompt: bool = True
    adjustor_method: str = "scale"  # 'scale' | 'gate' | 'residual'
    adjustor_hidden: int = 64
    template: str = "a photo of a {}"
    # Padded capacity of the class axis; grown in chunks of 8 when exceeded.
    max_classes: int = 8
    normalize_attribution: bool = True
    image_conditioned: bool = False
    meta_hidden: int = 0
    maple_depth: int = 0
    # "ref_compat" (the reference's bare-transformer pass) or "idiomatic"
    # (CoOp-style: positional embedding, causal mask, ln_final, EOT pooling).
    text_mode: str = "ref_compat"


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 2e-3
    weight_decay: float = 0.01
    epochs: int = 100
    patience: int = 10
    batch_size: int = 32
    num_shots: int = 5
    seed: int = 0
    attr_lambda: float = 1.0
    stab_lambda: float = 0.1
    kg_lambda: float = 0.0
    prograd_lambda: float = 0.0
    scl_lambda: float = 0.0
    anchor_templates: Tuple[str, ...] = ()


@dataclass(frozen=True)
class MeshConfig:
    dp: int = -1
    tp: int = 1


@dataclass(frozen=True)
class ExperimentConfig:
    model: CLIPConfig = VIT_B_32
    prompt: PromptConfig = PromptConfig()
    train: TrainConfig = TrainConfig()
    mesh: MeshConfig = MeshConfig()
    class_names: Tuple[str, ...] = (
        "Backpack",
        "Alarm_Clock",
        "Laptop",
        "Pen",
        "Mug",
    )
    data_root: str = "data/OfficeHomeDataset_10072016/Real World"
    pretrained_path: Optional[str] = None
    version: str = "main"
    output_root: str = "results"


def preset(name: str) -> ExperimentConfig:
    base = ExperimentConfig()
    presets = {
        "zeroshot_b32": dataclasses.replace(
            base,
            model=VIT_B_32,
            train=dataclasses.replace(base.train, num_shots=0),
            data_root="data/OfficeHomeDataset_10072016/Clipart",
        ),
        "fewshot16_b16": dataclasses.replace(
            base,
            model=VIT_B_16,
            train=dataclasses.replace(base.train, num_shots=16),
        ),
        "officehome_matrix": base,
        "domainnet": dataclasses.replace(
            base,
            prompt=dataclasses.replace(base.prompt, max_classes=352),
            data_root="data/domainnet",
        ),
        "vitl_unseen": dataclasses.replace(
            base,
            model=VIT_L_14,
            train=dataclasses.replace(base.train, batch_size=1024),
        ),
        "reference_train": base,
        "tiny": dataclasses.replace(base, model=TINY_TEST),
    }
    if name not in presets:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(presets)}")
    return presets[name]
