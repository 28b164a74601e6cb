from sgl_kernel_npu_tpu_torch.ops.mamba.causal_conv1d import (
    causal_conv1d_fn,
    causal_conv1d_update,
)

__all__ = ["causal_conv1d_fn", "causal_conv1d_update"]
