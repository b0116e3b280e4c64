from .quant import (DEFAULT_GROUP, INT4_Q, INT4_SCALE, INT8_Q, INT8_SCALE,  # noqa: F401
                    dequantize_grouped, dequantize_node, is_quant_node, make_quant_node,
                    node_bits, node_logical_shape, node_qs, pack_int4, quantize_grouped,
                    quantize_with_audit, unpack_int4, validate_quant_config)
from .fused_matmul import (QMM_BLOCK_COLS, QMM_STAGE_ROWS, QMM_TILES, QMM_WIDE,  # noqa: F401
                           SKINNY_M, QmmPlan, dense_weight_bytes, dequantize_to,
                           node_weight_bytes, qmm_plan, qmm_split, quant_dense_apply,
                           quantized_matmul, quantized_matmul_plain)
