"""tapclip_tpu_torch.utils"""
