"""Evidence runs: the port's counterparts of the JAX repository's
`scripts/head_to_head.py`, `quality_evidence.py`, `detector_evidence.py` and
`train_default_detector.py`, each a module with a `main(argv)`:

    python -m speinet_tpu_torch.evidence.head_to_head --phase gen|port|report
    python -m speinet_tpu_torch.evidence.quality
    python -m speinet_tpu_torch.evidence.detector
    python -m speinet_tpu_torch.evidence.default_detector

They run on the card unless `--device cpu` is given. `ssim_precision`
rescores restored frames with the SSIM filters' operands in bf16, as the
JAX package's metric computes on a TPU (host only):

    python -m speinet_tpu_torch.evidence.ssim_precision RESULTS EVAL_TREE
"""
