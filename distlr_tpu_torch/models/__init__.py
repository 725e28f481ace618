from distlr_tpu_torch.models.linear import BinaryLR, get_model  # noqa: F401
