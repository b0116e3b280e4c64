from .block_sparse import (BlockSparseAttnFunction, block_sparse_attention,  # noqa: F401
                           block_sparse_attention_reference, block_sparse_bwd,
                           block_sparse_bwd_dkv, block_sparse_bwd_dkv_plain,
                           block_sparse_bwd_dq, block_sparse_bwd_dq_plain, block_sparse_fwd,
                           block_sparse_fwd_plain, build_tables, make_sparse_attention_impl)
from .decode import decode_attention, decode_attention_plain  # noqa: F401
from .flash import (FlashAttnFunction, flash_attention, flash_bwd,  # noqa: F401
                    flash_bwd_dkv, flash_bwd_dkv_plain, flash_bwd_dq, flash_bwd_dq_plain,
                    flash_bwd_plain, flash_fwd, flash_fwd_plain)
