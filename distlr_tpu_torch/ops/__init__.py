from distlr_tpu_torch.ops import fused_lr, gen_roofline
from distlr_tpu_torch.ops.fused_lr import (  # noqa: F401
    BackwardPlan,
    LaunchPlan,
    fused_lr_grad,
    fused_lr_grad_int8dot,
    fused_lr_grad_int8dot_reference,
    fused_lr_grad_reference,
    fused_lr_grad_two_launch,
    fused_lr_supported,
    int8dot_weight_grid,
    lr_backward,
    lr_backward_int8dot,
    lr_backward_int8dot_reference,
    lr_backward_plan,
    lr_backward_reference,
    lr_launch_plan,
    lr_logits,
    lr_logits_int8dot,
    lr_logits_int8dot_reference,
    lr_logits_reference,
    lr_logits_row_blocks,
    lr_wide_plan,
)
from distlr_tpu_torch.ops.gen_roofline import (  # noqa: F401
    roofline_const,
    roofline_fwd,
    roofline_full,
    roofline_gen,
    roofline_hash,
    roofline_mxu,
)

#: every kernel wrapper of the port, for launch accounting
KERNEL_WRAPPERS = fused_lr.KERNEL_WRAPPERS + gen_roofline.KERNEL_WRAPPERS


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
