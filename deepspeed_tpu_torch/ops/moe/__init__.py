from .decode_ffn import (ACTIVATIONS, MOE_DECODE_FFN, moe_decode_ffn,  # noqa: F401
                         moe_decode_ffn_plain, moe_decode_ffn_quant, moe_decode_ffn_xla,
                         moe_plan)
