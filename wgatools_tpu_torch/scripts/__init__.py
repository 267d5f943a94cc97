"""The port's measurement programs (python -m wgatools_tpu_torch.scripts.NAME)."""
