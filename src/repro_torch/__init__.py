"""PyTorch + CUDA port of the SpaceVerse system: the request server
(Algorithm 1) and the training of its tiers.

A second package beside the JAX reference ``repro``: it imports ``torch``
and never ``jax``, and nothing of ``repro``.  Its subpackages mirror
``repro``'s (``configs``, ``kernels``, ``models``, ``data``, ``core``,
``serving``, ``network``, ``train``) so a reader finds each counterpart;
every TPU kernel of the JAX package (flash prefill, dense and paged
decode, paged prefix-append, Eq. 2 region scoring, the chunked
gated-linear-attention scan and the sLSTM recurrence) is hand-written CUDA
for Hopper under ``csrc/``, and so is the flash backward the training
attention runs (the JAX package's is a custom VJP in plain JAX).

Entry points run on the card unless the caller passes ``device="cpu"``
(``repro_torch.device.resolve_device``).
"""
