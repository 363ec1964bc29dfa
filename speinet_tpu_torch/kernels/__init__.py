"""Hand-written Hopper kernels of the port, one wrapper module each.

Each wrapper dispatches on its tensor's device alone: a CPU tensor takes
the plain PyTorch version kept beside it, a CUDA tensor launches the CUDA
kernel built from `speinet_tpu_torch/csrc/` (or raises). `LAUNCHES` counts
the kernel launches of each wrapper.

    K1 conv2d              csrc/conv.cu         (pallas_conv.py::conv2d_mxu)
    K2 swin_block          csrc/swin_block.cu   (pallas_swin.py::fused_swin_block)
    K3 roll2d              csrc/roll.cu         (pallas_roll.py::roll2d)
    K4 banded_corr_argmax  csrc/corr_banded.cu  (pallas_corr.py::banded_corr_argmax)
    K5 correlation_argmax_lds  csrc/corr_unfold.cu
                           (pallas_corr.py::correlation_argmax_pallas_lds)
"""

from speinet_tpu_torch.kernels._lib import LAUNCHES, reset_launches
from speinet_tpu_torch.kernels.conv import conv2d, conv2d_plain
from speinet_tpu_torch.kernels.corr import (banded_corr_argmax,
                                            banded_corr_argmax_plain,
                                            correlation_argmax_lds,
                                            correlation_argmax_lds_plain)
from speinet_tpu_torch.kernels.roll import roll2d, roll2d_plain
from speinet_tpu_torch.kernels.swin import (SwinBlockWeights, block_errors,
                                            block_errors_pass, swin_block,
                                            swin_block_plain)

__all__ = ["LAUNCHES", "reset_launches", "conv2d", "conv2d_plain",
           "banded_corr_argmax", "banded_corr_argmax_plain",
           "correlation_argmax_lds", "correlation_argmax_lds_plain", "roll2d",
           "roll2d_plain", "SwinBlockWeights", "block_errors", "block_errors_pass",
           "swin_block", "swin_block_plain"]
