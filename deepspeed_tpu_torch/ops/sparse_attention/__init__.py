"""Block-sparse attention patterns (counterpart of
``deepspeed_tpu/ops/sparse_attention``); the kernels that consume them live in
``ops/attention/block_sparse.py``."""
from .sparsity_config import (BigBirdSparsityConfig, BSLongformerSparsityConfig,  # noqa: F401
                              DenseSparsityConfig, FixedSparsityConfig,
                              LocalSlidingWindowSparsityConfig, SparsityConfig,
                              VariableSparsityConfig, layout_to_dense_mask)
