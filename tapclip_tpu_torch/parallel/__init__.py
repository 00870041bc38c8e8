"""Train and eval steps (counterpart of ``tapclip_tpu/parallel``; one device)."""
