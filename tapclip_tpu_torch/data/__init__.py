"""tapclip_tpu_torch.data"""
