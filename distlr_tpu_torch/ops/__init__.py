from distlr_tpu_torch.ops.fused_lr import (  # noqa: F401
    KERNEL_WRAPPERS,
    fused_lr_grad,
    fused_lr_grad_reference,
    fused_lr_supported,
    lr_logits,
    lr_logits_reference,
    reset_launch_counts,
)
