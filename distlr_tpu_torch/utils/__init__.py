from distlr_tpu_torch.utils.logging import (  # noqa: F401
    CheckError,
    check,
    check_eq,
    get_logger,
    log_eval_line,
)
