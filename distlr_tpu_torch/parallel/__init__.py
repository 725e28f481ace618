from distlr_tpu_torch.parallel.data_parallel import make_eval_step, make_sync_train_step  # noqa: F401
