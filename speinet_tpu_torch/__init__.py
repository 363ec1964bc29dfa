"""SPEINet on PyTorch and CUDA for NVIDIA Hopper (H100).

The port of `speinet_tpu` (JAX on a TPU), which stays in the repository as
the reference. The layout mirrors it: `config`, `ops`, `models`, `data`,
`utils`, `infer`, `training`, `main_train`; `kernels` holds the wrappers of
the hand-written CUDA kernels built from `csrc/`. This package imports
torch and numpy only (imageio and matplotlib where it writes images and
plots).
"""
