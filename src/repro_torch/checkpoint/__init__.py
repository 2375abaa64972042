from repro_torch.checkpoint.ckpt import restore_into, save_checkpoint  # noqa: F401
