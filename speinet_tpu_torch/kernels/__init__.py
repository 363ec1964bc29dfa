"""Hand-written Hopper kernels of the port, one wrapper module each.

Each wrapper dispatches on its tensor's device alone: a CPU tensor takes
the plain PyTorch version kept beside it, a CUDA tensor launches the CUDA
kernel built from `speinet_tpu_torch/csrc/` (or raises). `LAUNCHES` counts
the kernel launches of each wrapper, `BACKWARD_LAUNCHES` those made in a
backward pass. K3-K7 and K10 run under autograd (their backward: K3
itself, and plain PyTorch for the others, as XLA code in the JAX package);
K1, K2, K8 and K9 have no backward and refuse inputs that need one.
TPU kernels under speinet_tpu/ops/:

    K1  conv2d                  csrc/conv.cu         pallas_conv.py::conv2d_mxu
    K2  swin_block              csrc/swin_block.cu   pallas_swin.py::fused_swin_block
    K3  roll2d                  csrc/roll.cu         pallas_roll.py::roll2d
    K4  banded_corr_argmax      csrc/corr_banded.cu  pallas_corr.py::banded_corr_argmax
    K5  correlation_argmax_lds  csrc/corr_unfold.cu  pallas_corr.py::
                                                     correlation_argmax_pallas_lds
    K6  correlation_argmax_ld   csrc/corr_unfold.cu  correlation_argmax_pallas_ld
    K7  correlation_argmax      csrc/corr_unfold.cu  correlation_argmax_pallas
    K8  window_cross_attention  csrc/swin_attn.cu    pallas_swin.py::
                                                     fused_window_cross_attention
    K9  ln_mlp                  csrc/swin_mlp.cu     pallas_swin.py::fused_ln_mlp
    K10 row_gather              csrc/row_gather.cu   pallas_gather.py::row_gather
"""

from speinet_tpu_torch.kernels._lib import (BACKWARD_LAUNCHES, LAUNCHES,
                                            reset_launches)
from speinet_tpu_torch.kernels.conv import conv2d, conv2d_plain
from speinet_tpu_torch.kernels.corr import (banded_corr_argmax,
                                            banded_corr_argmax_plain,
                                            correlation_argmax,
                                            correlation_argmax_ld,
                                            correlation_argmax_ld_plain,
                                            correlation_argmax_lds,
                                            correlation_argmax_lds_plain,
                                            correlation_argmax_plain)
from speinet_tpu_torch.kernels.gather import row_gather, row_gather_plain
from speinet_tpu_torch.kernels.roll import roll2d, roll2d_plain
from speinet_tpu_torch.kernels.swin import (SwinBlockWeights, block_errors,
                                            block_errors_pass, ln_mlp,
                                            ln_mlp_plain, swin_block,
                                            swin_block_plain,
                                            window_cross_attention,
                                            window_cross_attention_plain)

__all__ = ["LAUNCHES", "BACKWARD_LAUNCHES", "reset_launches", "conv2d", "conv2d_plain",
           "banded_corr_argmax", "banded_corr_argmax_plain",
           "correlation_argmax_lds", "correlation_argmax_lds_plain",
           "correlation_argmax_ld", "correlation_argmax_ld_plain",
           "correlation_argmax", "correlation_argmax_plain", "row_gather",
           "row_gather_plain", "roll2d", "roll2d_plain", "SwinBlockWeights",
           "block_errors", "block_errors_pass", "swin_block", "swin_block_plain",
           "window_cross_attention", "window_cross_attention_plain", "ln_mlp",
           "ln_mlp_plain"]
