from distlr_tpu_torch.train.export import load_model_text, load_weights, save_model_text  # noqa: F401
from distlr_tpu_torch.train.trainer import GlobalShardedData, Trainer  # noqa: F401
