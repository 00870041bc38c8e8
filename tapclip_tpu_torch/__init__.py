"""tapclip_tpu_torch: the PyTorch + CUDA port of tapclip_tpu.

The JAX package ``tapclip_tpu`` stays the reference; this package mirrors its
module names (``config``, ``data.tokenizer``, ``ops.fused_mlp``,
``models.model_wrapper``, ``serve``, ...) so each module's counterpart is
easy to find.  Every Pallas kernel on the ported path is a hand-written CUDA
kernel for Hopper (``csrc/``), built by ``ops/_build.py`` at first use.  This
package imports ``torch`` and never ``jax``.

The top-level API is lazy, so ``import tapclip_tpu_torch`` pulls in nothing
heavy until a name is used.
"""

__version__ = "0.1.0"

NOT_PORTED = "not yet ported in tapclip_tpu_torch"


class NotPortedError(NotImplementedError):
    """A route, option or module of the JAX package that the port does not have yet."""

    def __init__(self, what: str):
        super().__init__(f"{what}: {NOT_PORTED}")


_LAZY = {
    "FullModel": ("tapclip_tpu_torch.models.model_wrapper", "FullModel"),
    "PromptLearner": ("tapclip_tpu_torch.models.prompt_learner", "PromptLearner"),
    "get_tokenizer": ("tapclip_tpu_torch.data.tokenizer", "get_tokenizer"),
    "PredictService": ("tapclip_tpu_torch.serve", "PredictService"),
    "params_from_jax": ("tapclip_tpu_torch.utils.jax_bridge", "params_from_jax"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'tapclip_tpu_torch' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
