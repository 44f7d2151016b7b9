"""PyTorch/CUDA port of ovmr_tpu for NVIDIA Hopper (H100).

A package of its own beside the JAX reference ``ovmr_tpu``: it imports
``torch``, ``numpy`` and the standard library, never JAX and nothing of
``ovmr_tpu``. The serving path (``ovmr_tpu_torch.api.OVMRGenerator``) and
the MM_CLS_OP trainer (``python -m ovmr_tpu_torch.train``) run the CLIP
towers on hand-written Hopper kernels (``ovmr_tpu_torch/csrc``).
"""
