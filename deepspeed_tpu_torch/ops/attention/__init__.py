from .decode import decode_attention, decode_attention_plain  # noqa: F401
from .flash import (FlashAttnFunction, flash_attention, flash_bwd,  # noqa: F401
                    flash_bwd_dkv, flash_bwd_dkv_plain, flash_bwd_dq, flash_bwd_dq_plain,
                    flash_bwd_plain, flash_fwd, flash_fwd_plain)
