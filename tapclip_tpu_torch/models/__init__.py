"""tapclip_tpu_torch.models"""
