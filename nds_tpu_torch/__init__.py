"""nds_tpu_torch: the PyTorch/CUDA port of the ``nds_tpu`` engine.

A second package beside ``nds_tpu`` that runs the same plans on an NVIDIA
H100 through PyTorch tensors and CUDA C++ kernels written for Hopper
(``csrc/``). It imports ``torch``, ``numpy`` and ``pandas``, never
``jax`` and nothing of ``nds_tpu``: the jax-free modules it needs are its
own copies. Its entry points run on the card unless the caller asks for
the CPU (``make_device_factory(device="cpu")``, as the tests do).
"""

__version__ = "0.1.0"
