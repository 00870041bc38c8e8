"""tapclip_tpu_torch.examples: runnable tours of the port."""
