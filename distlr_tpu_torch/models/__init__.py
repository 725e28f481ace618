from distlr_tpu_torch.models.linear import (  # noqa: F401
    BinaryLR,
    BlockedSparseLR,
    SoftmaxRegression,
    SparseBinaryLR,
    SparseSoftmaxRegression,
    get_model,
)
