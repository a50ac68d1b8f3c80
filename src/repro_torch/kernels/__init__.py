"""Kernels of the port: hand-written CUDA for Hopper, their plain versions.

- ``ref``               plain PyTorch versions (the CPU path and the oracle)
- ``flash_attention``   prefill attention, ``csrc/flash_attention.cu``
- ``decode_attention``  dense flash-decoding, ``csrc/decode_attention.cu``
- ``region_score``      Eq. (2) scoring, ``csrc/region_score.cu``
- ``ops``               device-based dispatch + layout adaptation
- ``build``             nvcc build into ``build/kernels/`` and ctypes binding
"""
