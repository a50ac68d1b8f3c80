"""xlstm-125m — sLSTM + mLSTM blocks. [arXiv:2405.04517; unverified]

12L d_model=768 4H d_ff=0 vocab=50304.  Period-6 pattern with one sLSTM per
five mLSTM (xLSTM[a:b]-style interleave).  d_ff=0: xLSTM blocks carry their
own up/down projections, no separate FFN.  The port's own copy of
``repro.configs.xlstm_125m``.
"""
from repro_torch.configs.base import ArchConfig, BlockSpec, MLSTM, SLSTM

_M = BlockSpec(kind=MLSTM)
_S = BlockSpec(kind=SLSTM)

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    head_dim=192,
    ssm_heads=4,
    block_pattern=(_M, _M, _S, _M, _M, _S),
    tie_embeddings=True,
    supports_long_context=True,   # O(1) recurrent state
)
