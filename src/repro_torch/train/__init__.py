"""Training runtime of the port: AdamW with warmup-cosine and clipping, the
train step with gradient accumulation and compression, checkpoints in the
JAX package's flat-path ``.npz`` format, elastic recovery plans.  The
training shard rules (ZeRO-1) are not ported."""
from repro_torch.train import (checkpoint, compression, elastic,  # noqa: F401
                               optimizer, trainer)
