"""tapclip_tpu_torch.ops: hand-written CUDA kernels and their plain PyTorch versions."""
