from .decode import decode_attention, decode_attention_plain  # noqa: F401
from .flash import flash_attention, flash_fwd, flash_fwd_plain  # noqa: F401
