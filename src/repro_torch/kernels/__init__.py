"""Kernels of the port: hand-written CUDA for Hopper, their plain versions.

- ``ref``               plain PyTorch versions (the CPU path and the oracle)
- ``flash_attention``   prefill attention, ``csrc/flash_attention.cu``
- ``decode_attention``  dense flash-decoding, ``csrc/decode_attention.cu``
- ``paged_decode_attention``  the same through a block table over page
                        pools (slot decode and speculative verify)
- ``paged_prefill_attention``  chunked prefill's prefix-append attention
                        through a block table,
                        ``csrc/paged_prefill_attention.cu``
- ``region_score``      Eq. (2) scoring, ``csrc/region_score.cu``
- ``ssm_scan``          chunked gated linear-attention scan (the mLSTM
                        core), ``csrc/ssm_scan.cu``
- ``slstm_scan``        the sLSTM recurrence from an initial state,
                        ``csrc/slstm_scan.cu``
- ``kv_quant``          int8 / fp8 KV-page quantizers and the parity
                        strategies (the paged kernels read 8-bit pools)
- ``ops``               device-based dispatch + layout adaptation
- ``build``             nvcc build into ``build/kernels/`` and ctypes binding
"""
