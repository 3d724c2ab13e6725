"""PyTorch/CUDA port of the FLrce reproduction.

A second package beside the JAX reference (``repro``): the paper's
Algorithm 4 on ``MLPClassifier``/``PaperCNN`` with the batched engine and the
per-round loop driver, the §4.1 baselines, and greedy batched serving of the
dense attention-only language models (``launch.serve``), on one NVIDIA GPU.
The reference's Pallas kernels (``cross_gram``, ``gram``,
``weighted_aggregate``, ``topk_mask_rows``, ``decode_attention``) are CUDA
C++ kernels here (``repro_torch.kernels``).  Entry points run on ``"cuda"``
unless the caller passes ``"cpu"``; on the CPU each kernel's plain PyTorch
version runs instead.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
