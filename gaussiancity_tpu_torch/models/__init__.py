from gaussiancity_tpu_torch.models.generator import Generator  # noqa: F401
