"""Kernel-vs-plain checks on the card: ONE source of shapes and tolerances.

Shared by ``chip_smoke.py`` and the card-only test
``tests/test_torch_kernels_cuda.py``, so the two cannot drift. Each case builds
seeded inputs on the card, calls the kernel's public wrapper and its plain
PyTorch version on the same inputs, and compares them in the working dtype.
The first case of each kernel is the shape its main path gives it: serving
(GPT-2 125M, batch 4, prompt 512) for the forward and dense decode kernels,
continuous-batching serving (GPT-2 125M, 16 slots, page 16, a 250-token
shared prefix) for the paged decode kernel, training (GPT-2 125M,
micro-batch 24, seq 1024) for the two backward kernels, weight-quantized
serving (BLOOM-7B decode, batch 1) for the dequant-GEMM, MoE serving (GPT-2
125M with 8 experts, decode at batch 1) for the selected-expert FFN,
block-sparse training (GPT-2 125M, micro-batch 24, seq 1024, the Fixed layout
of block 16 in ``GPT2_SPARSE``) for the three block-sparse kernels. The
cases with an ``hd_run`` are the shapes ``chip_smoke.py``'s ``[hd]`` phase
gives the attention kernels at head dims other than 64 and 128 (GPT-2 2.7B
d 80, GPT-2 760M d 96, GPT-J-6B d 256), which run on the 128- and 256-wide
builds; the tolerances are the same at every head dim.

Every kernel is held to its plain version elementwise: every element of
every output must have |kernel - plain| <= atol + rtol * |plain|, with
(atol, rtol) by kernel and input dtype. One absolute limit cannot do: at
the decode main shape a typical output element is about 0.07 (the sum of
p**2 is about e / n over n ~ 544 rows), while early causal rows of the
forward reach 2-3, so a limit loose enough for the largest values passes a
kernel that is wrong by 20 % on most rows.

- Dense and paged decode, ``DECODE_TOLERANCES``: both sides compute in f32
  and round to the input dtype once, at the end, so f32 sums in another
  order can at most flip that last rounding; rtol is one ulp of the value.
  bfloat16 (1e-5, 8e-3): 8 significant bits, an ulp is at most 2**-7 of the
  value. float16 (1e-5, 1e-3): 11 bits, 2**-10. float32 (2e-5, 2e-5): sums
  of up to 2,048 terms of size ~1 in another order, and expf (K5: exp2f of
  scores scaled by log2 e) against torch's exp. atol covers values near 0, where f32 noise exceeds an ulp.
  A sequence or paged slot with cache_len 0 gets zeros, as the TPU kernel
  gives it (its l_safe); the plain version, as ``decode_attention_xla`` and
  ``paged_attention_xla``, averages that sequence's masked rows instead, so
  the reference is zeroed there (``run_plain``), and the kernel's output
  memory holds 1e4 before the launch (``make_inputs``), so an unwritten row
  shows.
- The flash forward's o, ``FWD_TOLERANCES``: the kernel rounds each
  unnormalised probability (relative to the running max) to the input dtype
  before its product with v, the plain version rounds the normalised one,
  so every term of o moves by up to an ulp of itself on each side. Where a
  row has few keys whose terms cancel (early causal rows), that leaves an
  absolute error near an ulp of the largest term, far above an ulp of the
  small sum. bfloat16 (1e-2, 1.6e-2) and float16 (1.5e-3, 2e-3): rtol two
  ulps of the value, atol an ulp of a term of size ~2. float32 (2e-5,
  2e-5), as decode: p is not rounded. The f32 lse keeps its absolute limit,
  ``LSE_TOLERANCE``.
- The backward kernels, ``BWD_TOLERANCES``: most gradients at these shapes
  are of order 0.01-0.1, and a few reach 4-5 (causal: early key columns
  collect many rows). The kernel and the plain version sum in different
  orders, and ds is rounded to the input dtype before its products, where a
  different f32 sum can flip that rounding by an ulp. bfloat16 (2e-3,
  1.6e-2): rtol is 2 bf16 ulps of the value; atol covers values near 0,
  where a flipped rounding of a small ds moves a sum by more than its own
  ulps. It does not cover a flipped large ds: at the training shape one ds
  of 0.13 lies within two f32 ulps of a bf16 halfway point, and its flip moves
  dq by 2.8e-3 (|k| 2.8) where |dq| is 0.02. So the dq kernel's
  tensor-core path rounds such a ds from its in-order f32 value
  (``csrc/flash_bwd_dq.cu``), the value of the kernel's first version,
  whose dq matched this plain version's bit for bit at d 64.
  float16 (2.5e-4, 2e-3): the same two ulps and atol at fp16's 11 bits.
  float32 (2e-6, 2e-5): f32 sums of up to t = 1024 terms in other orders,
  with p = exp(s - lse) moving with s's last bits.
- The dequant-GEMM, ``QMM_TOLERANCES``: both sides dequantize each weight
  element in f32 and round it to x's dtype, so every product is the same
  (exact in f32 for 16-bit inputs); only the f32 sum differs: the kernel's
  order (wgmma's internal accumulation and, at decode, f32 partials of
  k-splits added in order; the f32 path's split-k sum) against cuBLAS's f32
  GEMM. The inputs give
  outputs of order 1 (w ~ N(0, 1/k) before quantization, x ~ N(0, 1)), where
  that noise is at most ~1e-4 at k = 16,384. Both round the f32 result to
  the output dtype once, which can flip by one ulp. bfloat16 (1e-3, 8e-3)
  and float16 (1e-3, 1e-3): rtol one ulp of the value, atol ten times the
  sum noise for values near 0. float32 (2e-5, 2e-5): sums of up to 512
  terms in other orders.
- The selected-expert FFN, ``MOE_TOLERANCES``: both sides take exact
  products of the stored values with f32 sums (the kernel's order against
  cuBLAS's f32 GEMM on the gathered weights), add b1 and apply the
  activation in f32, round h to the dtype once, and return y in f32 without
  a final rounding. The f32 noise of a sum (~1e-6 at d = 1,024) flips the
  rounding of about one h element a token by one ulp, which moves y by
  ulp(h) x |w2|: at most ~2e-3 in bfloat16 (h up to ~5, ulp 2**-5, w2 ~
  N(0, 1/f) up to 4 sigma), ~2.5e-4 in float16. bfloat16 (2e-3, 8e-3) and
  float16 (2.5e-4, 1e-3): atol that flip, rtol room for a few smaller ones
  on outputs of order 1 (x ~ N(0, 1), w1 ~ N(0, 1/d), biases ~ N(0, 1/4)).
  float32 (2e-5, 2e-5): h is not rounded; sums of up to 4,096 terms in
  other orders.
- The block-sparse kernels reuse ``FWD_TOLERANCES`` (o), ``LSE_TOLERANCE``
  and ``BWD_TOLERANCES`` (dq, dk, dv). The forward's bf16/fp16 path runs on
  the tensor cores and rounds each unnormalised p to the input dtype before
  its product with v, as the flash forward does, which is what
  ``FWD_TOLERANCES`` was set for. The backward kernels' f32 paths round
  neither p nor ds, as the TPU kernels do: both sides compute in f32 and
  round each output once, at the end, and f32 sums in another order can at
  most flip that rounding (one ulp, inside every rtol above). The dq and
  dk/dv kernels' bf16/fp16 paths keep that f32 ds (and p) on the tensor
  cores by splitting each into hi = ds rounded to the input dtype and lo =
  (ds - hi) rounded to it, both products summed into one f32 accumulator
  (dq += hi k + lo k; dk likewise with ds and q, dv with p and do): k, q and
  do are exact in their dtype, so each product keeps ~16 (bf16) or ~22
  (fp16) bits of p and ds, a relative error of at most 2^-16 or 2^-22 a term
  (fp16 subnormals add at most 6e-8 absolute a term), far inside the same
  limits, and no rounding can flip at a halfway point. The f32 cases sum fewer
  terms than the flash cases those limits were set for (a row walks at most
  its active blocks). Rows whose walked entries are all masked (an lse of
  -1e30, p = 1) and empty rows (zeros) come out the same on both sides: the
  lse is -1e30 exactly.

f32 matrix products of the plain versions run in full f32
(``torch.backends.cuda.matmul.allow_tf32 = False``, set here).
"""

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.causal_lm import alibi_slopes
from . import sparse_attention
from .attention.block_sparse import (block_sparse_bwd_dkv, block_sparse_bwd_dkv_plain,
                                     block_sparse_bwd_dq, block_sparse_bwd_dq_plain,
                                     block_sparse_fwd, block_sparse_fwd_plain, build_tables,
                                     device_tables, kernel_tile_tables)
from .attention.decode import decode_attention, decode_attention_plain, decode_split
from .attention.flash import (flash_bwd_dkv, flash_bwd_dkv_plain, flash_bwd_dq,
                             flash_bwd_dq_plain, flash_fwd, flash_fwd_plain)
from .moe import moe_decode_ffn, moe_decode_ffn_plain, moe_decode_ffn_xla
from .paged_attention import (gather_kv_dense, paged_attention, paged_attention_plain,
                              paged_split)
from .quantizer import (dequantize_to, pack_int4, quantize_grouped, quantized_matmul,
                        quantized_matmul_plain)
from .quantizer.quant import _group_size

#: (atol, rtol) by input dtype, for each family of kernels (see above)
FWD_TOLERANCES = {torch.bfloat16: (1e-2, 1.6e-2), torch.float16: (1.5e-3, 2e-3),
                  torch.float32: (2e-5, 2e-5)}
DECODE_TOLERANCES = {torch.bfloat16: (1e-5, 8e-3), torch.float16: (1e-5, 1e-3),
                     torch.float32: (2e-5, 2e-5)}
BWD_TOLERANCES = {torch.bfloat16: (2e-3, 1.6e-2), torch.float16: (2.5e-4, 2e-3),
                  torch.float32: (2e-6, 2e-5)}
BWD_KERNELS = ("flash_bwd_dq", "flash_bwd_dkv")
#: the kernels whose bf16/fp16 paths run wgmma with TMA loads (f32: the CUDA cores)
WGMMA_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "block_sparse_fwd",
                 "block_sparse_bwd_dq", "block_sparse_bwd_dkv", "quantized_matmul")
BS_KERNELS = ("block_sparse_fwd", "block_sparse_bwd_dq", "block_sparse_bwd_dkv")
FWD_KERNELS = ("flash_fwd", "block_sparse_fwd")      # (o, f32 lse)
LSE_TOLERANCE = 1e-3        # f32 logsumexp; sums of exp in another order
QMM_TOLERANCES = {torch.bfloat16: (1e-3, 8e-3), torch.float16: (1e-3, 1e-3),
                  torch.float32: (2e-5, 2e-5)}
MOE_TOLERANCES = {torch.bfloat16: (2e-3, 8e-3), torch.float16: (2.5e-4, 1e-3),
                  torch.float32: (2e-5, 2e-5)}

#: H100 SXM published peaks (NVIDIA data sheet, dense): bytes/s of device
#: memory, operations/s by input dtype (bf16/fp16 on the tensor cores, f32
#: outside them)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12}

#: what each kernel replaces in the JAX package, and its source here
KERNEL_INFO = {
    "flash_fwd": {"source": "deepspeed_tpu_torch/ops/csrc/flash_fwd.cu",
                  "replaces": "deepspeed_tpu/ops/attention/flash.py:96"},
    "decode_attention": {"source": "deepspeed_tpu_torch/ops/csrc/decode_attention.cu",
                         "replaces": "deepspeed_tpu/ops/attention/decode.py:30"},
    "flash_bwd_dq": {"source": "deepspeed_tpu_torch/ops/csrc/flash_bwd_dq.cu",
                     "replaces": "deepspeed_tpu/ops/attention/flash.py:205"},
    "flash_bwd_dkv": {"source": "deepspeed_tpu_torch/ops/csrc/flash_bwd_dkv.cu",
                      "replaces": "deepspeed_tpu/ops/attention/flash.py:257"},
    "paged_decode_attention": {
        "source": "deepspeed_tpu_torch/ops/csrc/paged_decode_attention.cu",
        "replaces": "deepspeed_tpu/ops/paged_attention.py:111"},
    "quantized_matmul": {"source": "deepspeed_tpu_torch/ops/csrc/quantized_matmul.cu",
                         "replaces": "deepspeed_tpu/ops/quantizer/fused_matmul.py:67"},
    "moe_decode_ffn": {"source": "deepspeed_tpu_torch/ops/csrc/moe_decode_ffn.cu",
                       "replaces": "deepspeed_tpu/ops/moe/decode_ffn.py:31"},
    "block_sparse_fwd": {"source": "deepspeed_tpu_torch/ops/csrc/block_sparse_fwd.cu",
                         "replaces": "deepspeed_tpu/ops/attention/block_sparse.py:69"},
    "block_sparse_bwd_dq": {"source": "deepspeed_tpu_torch/ops/csrc/block_sparse_bwd_dq.cu",
                            "replaces": "deepspeed_tpu/ops/attention/block_sparse.py:137"},
    "block_sparse_bwd_dkv": {"source": "deepspeed_tpu_torch/ops/csrc/block_sparse_bwd_dkv.cu",
                             "replaces": "deepspeed_tpu/ops/attention/block_sparse.py:170"},
}

#: the block-sparse training main path's layout: the ``fixed`` mode of
#: DeepSpeed's sparse-attention tutorial (block 16, 4 local blocks, 1 global,
#: 4 global patterns), unidirectional because GPT-2 is causal; at t 1024
#: every head walks 640 of 4,096 blocks, and the heads' layouts differ
GPT2_SPARSE = ("FixedSparsityConfig", dict(
    num_heads=12, block=16, different_layout_per_head=True, num_local_blocks=4,
    num_global_blocks=1, attention="unidirectional", num_different_global_patterns=4))
#: the same layout over GPT-2 760M's 16 heads (head_dim 96), for ``[hd]``
GPT2_760M_SPARSE = (GPT2_SPARSE[0], {**GPT2_SPARSE[1], "num_heads": 16})


@dataclasses.dataclass
class Case:
    kernel: str                  # a key of KERNEL_INFO
    name: str
    # flash (fwd and bwd): b, t, h, d; decode: b, h, hk, T, d; paged: b, h,
    # hk, page, cap, d (max_pages = cdiv(cap, page)); dequant-GEMM: m, k, n,
    # group (requested; the quantizer may degrade it), bits; selected-expert
    # FFN: n rows (tokens x k), e, d, f, k experts a token (distinct);
    # block-sparse: b, t, h, d (the layout block is the config's)
    dims: Dict[str, int]
    dtype: torch.dtype
    causal: bool = True
    alibi: bool = False
    lens: Optional[Tuple[int, ...]] = None      # decode and paged: valid rows per sequence
    main_path: bool = False
    # the ``[hd]`` run of ``chip_smoke.py`` that gives the kernel this shape at a
    # head_dim other than 64 or 128, as a path into its results: "gpt2_2.7b/
    # generate", "gpt2_2.7b/serve", "gptj_6b/generate", "gptj_6b/serve",
    # "gpt2_760m_train", "gpt2_760m_sparse"
    hd_run: Optional[str] = None
    activation: str = "gelu"                    # selected-expert FFN
    # block-sparse: a SparsityConfig's class name in ops/sparse_attention and
    # its arguments, or ("hand-made", {"block": ...}) for hand_made_layout()
    layout: Optional[Tuple[str, Dict[str, Any]]] = None

    def tolerance(self) -> Tuple[float, float]:
        if self.kernel in BWD_KERNELS or self.kernel in BS_KERNELS[1:]:
            return BWD_TOLERANCES[self.dtype]
        if self.kernel in FWD_KERNELS:
            return FWD_TOLERANCES[self.dtype]
        if self.kernel == "quantized_matmul":
            return QMM_TOLERANCES[self.dtype]
        if self.kernel == "moe_decode_ffn":
            return MOE_TOLERANCES[self.dtype]
        return DECODE_TOLERANCES[self.dtype]


# the [serve] phase's slots mid-run: a 250-token prefix, suffixes of 8-256
# tokens and up to 128 generated ones
SERVE_LENS = (262, 290, 318, 347, 375, 403, 431, 460, 488, 516, 545, 573, 601, 630, 300, 420)

CASES: List[Case] = [
    Case("flash_fwd", "gpt2-prefill", dict(b=4, t=512, h=12, d=64), torch.bfloat16,
         main_path=True),
    # the training main path's forward: GPT-2 125M, micro-batch 24, seq 1024
    Case("flash_fwd", "gpt2-train", dict(b=24, t=1024, h=12, d=64), torch.bfloat16),
    Case("flash_fwd", "fp32", dict(b=2, t=1024, h=4, d=64), torch.float32),
    Case("flash_fwd", "alibi", dict(b=2, t=512, h=4, d=64), torch.bfloat16, alibi=True),
    Case("flash_fwd", "ragged-t500", dict(b=2, t=500, h=4, d=64), torch.bfloat16),
    Case("flash_fwd", "d128", dict(b=1, t=2048, h=32, d=128), torch.bfloat16),
    Case("flash_fwd", "fp16-full-d128", dict(b=2, t=300, h=4, d=128), torch.float16,
         causal=False),
    # lens: the midpoint of the main path's decode (prompts 512, 512, 512, 384)
    Case("decode_attention", "gpt2-decode", dict(b=4, h=12, hk=12, T=1024, d=64),
         torch.bfloat16, lens=(544, 544, 544, 416), main_path=True),
    Case("decode_attention", "gqa-d128", dict(b=4, h=16, hk=4, T=2048, d=128),
         torch.bfloat16, lens=(2048, 1337, 700, 101)),
    Case("decode_attention", "fp32-gqa-T300", dict(b=3, h=8, hk=2, T=300, d=64),
         torch.float32, lens=(300, 65, 1)),
    # a sequence with cache_len 0 (zeros), and one of 17 rows whose splits but
    # the first walk nothing
    Case("decode_attention", "bf16-gqa-empty-slot", dict(b=4, h=8, hk=2, T=512, d=128),
         torch.bfloat16, lens=(300, 0, 17, 512)),
    # Qwen2-7B's attention (28 query heads, 4 kv heads, d 128): groups of 7
    # take two head blocks, the second of 3 heads
    Case("decode_attention", "qwen2-g7-d128", dict(b=2, h=28, hk=4, T=1024, d=128),
         torch.bfloat16, lens=(1024, 77)),
    # Mistral-7B's (32 query heads, 8 kv heads, d 128) at batch 4: four-head
    # blocks, one an SM by their registers
    Case("decode_attention", "mistral7b-b4-d128", dict(b=4, h=32, hk=8, T=2048, d=128),
         torch.bfloat16, lens=(2048, 1500, 700, 33)),
    # head dims other than 64 and 128 (the 128- and 256-wide builds, lanes
    # past d idle): [hd]'s GPT-2 2.7B (d 80) and GPT-J-6B (d 256) decode at
    # [main]'s lengths, f32 and an empty slot at d 96, f32 at d 256 (two
    # 16-byte pieces a lane), d 32 on the 64-wide build
    Case("decode_attention", "gpt2-2.7b-decode", dict(b=4, h=32, hk=32, T=1024, d=80),
         torch.bfloat16, lens=(544, 544, 544, 416), hd_run="gpt2_2.7b/generate"),
    Case("decode_attention", "gptj-decode", dict(b=4, h=16, hk=16, T=1024, d=256),
         torch.bfloat16, lens=(544, 544, 544, 416), hd_run="gptj_6b/generate"),
    Case("decode_attention", "fp32-gqa-d96", dict(b=3, h=8, hk=2, T=300, d=96),
         torch.float32, lens=(300, 65, 1)),
    Case("decode_attention", "bf16-gqa-empty-slot-d96", dict(b=4, h=8, hk=2, T=512, d=96),
         torch.bfloat16, lens=(300, 0, 17, 512)),
    Case("decode_attention", "fp32-gqa-d256", dict(b=2, h=8, hk=2, T=300, d=256),
         torch.float32, lens=(300, 77)),
    Case("decode_attention", "gqa-d32", dict(b=2, h=8, hk=2, T=300, d=32), torch.bfloat16,
         lens=(300, 77)),
    Case("paged_decode_attention", "gpt2-serve",
         dict(b=16, h=12, hk=12, page=16, cap=1024, d=64), torch.bfloat16, lens=SERVE_LENS,
         main_path=True),
    Case("paged_decode_attention", "gqa-d128", dict(b=4, h=16, hk=4, page=16, cap=2048, d=128),
         torch.bfloat16, lens=(2048, 1337, 700, 101)),
    # cap not a multiple of the page; the JAX tests' page size
    Case("paged_decode_attention", "fp32-gqa-page8-cap300",
         dict(b=3, h=8, hk=2, page=8, cap=300, d=64), torch.float32, lens=(300, 65, 1)),
    Case("paged_decode_attention", "fp16-page1", dict(b=2, h=4, hk=4, page=1, cap=200, d=64),
         torch.float16, lens=(200, 37)),
    Case("paged_decode_attention", "bf16-page5-d128",
         dict(b=3, h=8, hk=8, page=5, cap=512, d=128), torch.bfloat16, lens=(512, 333, 6)),
    # a slot with cache_len 0 (zeros), and one of 17 rows split 8 ways: six of
    # its eight blocks walk nothing
    Case("paged_decode_attention", "bf16-gqa-empty-slot",
         dict(b=4, h=8, hk=2, page=16, cap=512, d=128), torch.bfloat16, lens=(300, 0, 17, 512)),
    Case("paged_decode_attention", "qwen2-g7-d128",
         dict(b=2, h=28, hk=4, page=16, cap=1024, d=128), torch.bfloat16, lens=(1024, 77)),
    # [hd]'s scheduler runs: GPT-2 2.7B (d 80) over 16 slots and GPT-J-6B
    # (d 256) over 8, at [serve]'s lengths; f32 at d 256 with GQA
    Case("paged_decode_attention", "gpt2-2.7b-serve",
         dict(b=16, h=32, hk=32, page=16, cap=1024, d=80), torch.bfloat16, lens=SERVE_LENS,
         hd_run="gpt2_2.7b/serve"),
    Case("paged_decode_attention", "gptj-serve",
         dict(b=8, h=16, hk=16, page=16, cap=1024, d=256), torch.bfloat16,
         lens=SERVE_LENS[:8], hd_run="gptj_6b/serve"),
    Case("paged_decode_attention", "fp32-gqa-page8-d256",
         dict(b=3, h=8, hk=2, page=8, cap=300, d=256), torch.float32, lens=(300, 65, 1)),
] + [c for kernel in BWD_KERNELS for c in (
    # the training main path: GPT-2 125M, micro-batch 24, seq 1024
    Case(kernel, "gpt2-train", dict(b=24, t=1024, h=12, d=64), torch.bfloat16,
         main_path=True),
    Case(kernel, "d128", dict(b=2, t=1024, h=8, d=128), torch.bfloat16),
    Case(kernel, "ragged-t1000", dict(b=2, t=1000, h=4, d=64), torch.bfloat16),
    Case(kernel, "alibi", dict(b=2, t=512, h=4, d=64), torch.bfloat16, alibi=True),
    Case(kernel, "fp32", dict(b=2, t=1024, h=4, d=64), torch.float32),
    Case(kernel, "fp16-full-d128", dict(b=2, t=300, h=4, d=128), torch.float16,
         causal=False),
    # head dims other than 64 and 128 on the 128-wide build: [hd]'s GPT-2
    # 760M training (d 96), a ragged d 80, f32 at d 96
    Case(kernel, "gpt2-760m-train", dict(b=8, t=1024, h=16, d=96), torch.bfloat16,
         hd_run="gpt2_760m_train"),
    Case(kernel, "ragged-t1000-d80", dict(b=2, t=1000, h=4, d=80), torch.bfloat16),
    Case(kernel, "fp32-d96", dict(b=2, t=300, h=4, d=96), torch.float32),
)] + [
    # the forward at head dims other than 64 and 128: [hd]'s GPT-2 2.7B
    # prefill (d 80), GPT-2 760M training (d 96) and GPT-J-6B prefill (d 256,
    # the 256-wide build, serving only), f32 at d 80 and d 256
    Case("flash_fwd", "gpt2-2.7b-prefill", dict(b=4, t=512, h=32, d=80), torch.bfloat16,
         hd_run="gpt2_2.7b/generate"),
    Case("flash_fwd", "gpt2-760m-train", dict(b=8, t=1024, h=16, d=96), torch.bfloat16,
         hd_run="gpt2_760m_train"),
    Case("flash_fwd", "gptj-prefill", dict(b=4, t=512, h=16, d=256), torch.bfloat16,
         hd_run="gptj_6b/generate"),
    Case("flash_fwd", "ragged-t300-d256-fp16", dict(b=2, t=300, h=4, d=256), torch.float16,
         causal=False),
    Case("flash_fwd", "fp32-d80", dict(b=2, t=300, h=4, d=80), torch.float32),
    Case("flash_fwd", "fp32-d256", dict(b=1, t=200, h=2, d=256), torch.float32),
] + [c for kernel in ("flash_fwd",) + BWD_KERNELS for c in (
    # the flash wgmma kernels' tilings: 64-row tiles, blocks of 64 or 128 rows, a
    # ring of K/V (K1, K3) or q/do (K4) stages. A t shorter than one tile, a t one tile and
    # two rows long, a causal walk that wraps the ring many times, fp16 causal;
    # head dims 80 and 48 (panels past d zero-filled, stores stopped at d).
    Case(kernel, "t40", dict(b=2, t=40, h=4, d=64), torch.bfloat16),
    Case(kernel, "t130-d128", dict(b=2, t=130, h=4, d=128), torch.bfloat16),
    Case(kernel, "t130-d80", dict(b=2, t=130, h=4, d=80), torch.bfloat16),
    Case(kernel, "t130-d48", dict(b=2, t=130, h=4, d=48), torch.bfloat16),
    Case(kernel, "long-t4096", dict(b=1, t=4096, h=4, d=64), torch.bfloat16),
    Case(kernel, "fp16-causal", dict(b=2, t=1024, h=4, d=64), torch.float16),
)] + [
    # weight-quantized serving: BLOOM-7B (n_embd 4096, ffn 16,384, group 128)
    # decode at batch 1 and prefill of 512 tokens, then GPT-2 125M decode over
    # the scheduler's 16 slots
    Case("quantized_matmul", "bloom7b-decode-fc_in-int8",
         dict(m=1, k=4096, n=16384, group=128, bits=8), torch.bfloat16, main_path=True),
    Case("quantized_matmul", "bloom7b-decode-fc_out-int4",
         dict(m=1, k=16384, n=4096, group=128, bits=4), torch.bfloat16),
    Case("quantized_matmul", "bloom7b-prefill-q_proj-int8",
         dict(m=512, k=4096, n=4096, group=128, bits=8), torch.bfloat16),
    Case("quantized_matmul", "bloom7b-prefill-fc_in-int4",
         dict(m=512, k=4096, n=16384, group=128, bits=4), torch.bfloat16),
    Case("quantized_matmul", "gpt2-serve-decode-fc_in-int8",
         dict(m=16, k=768, n=3072, group=128, bits=8), torch.bfloat16),
    Case("quantized_matmul", "fp32-ragged-int8", dict(m=300, k=256, n=200, group=64, bits=8),
         torch.float32),
    Case("quantized_matmul", "fp16-int4", dict(m=3, k=512, n=72, group=32, bits=4),
         torch.float16),
    # k 200: a requested group of 128 degrades to 8
    Case("quantized_matmul", "k200-g8-int4", dict(m=37, k=200, n=96, group=128, bits=4),
         torch.bfloat16),
    # the same at decode: 4 payload rows a group, fewer than a k-step
    Case("quantized_matmul", "k200-g8-int4-decode", dict(m=2, k=200, n=96, group=128, bits=4),
         torch.bfloat16),
    # k 13: group 1, and n not a multiple of 4
    Case("quantized_matmul", "fp32-k13-g1-n70-int8", dict(m=4, k=13, n=70, group=8, bits=8),
         torch.float32),
    # the wgmma kernel's tile edges: GPT-2's fc_out at the scheduler's 16
    # slots (12 column tiles, so k-splits); 3 m tiles of 128, the last of 44
    # rows, and 320 columns, so the last block's second warpgroup lies wholly
    # past n; n 200 (not a multiple of 64, nor of 16: the payload by plain
    # loads); an int4 prefill at group 8 (x gathered: a stage's low rows span
    # 16 groups)
    Case("quantized_matmul", "gpt2-serve-decode-fc_out-int8",
         dict(m=16, k=3072, n=768, group=128, bits=8), torch.bfloat16),
    Case("quantized_matmul", "m300-n320-int8", dict(m=300, k=512, n=320, group=128, bits=8),
         torch.bfloat16),
    Case("quantized_matmul", "n200-int4", dict(m=5, k=1024, n=200, group=128, bits=4),
         torch.bfloat16),
    Case("quantized_matmul", "prefill-g8-int4", dict(m=160, k=1024, n=256, group=8, bits=4),
         torch.bfloat16),
    # MoE serving: GPT-2 125M with 8 experts (d 768, f 3072) decode at batch 1
    # (generate), the scheduler's 16 slots, top-2 at batch 1
    Case("moe_decode_ffn", "gpt2moe-decode-n1", dict(n=1, e=8, d=768, f=3072, k=1),
         torch.bfloat16, main_path=True),
    Case("moe_decode_ffn", "gpt2moe-serve-n16", dict(n=16, e=8, d=768, f=3072, k=1),
         torch.bfloat16),
    Case("moe_decode_ffn", "gpt2moe-top2-n2", dict(n=2, e=8, d=768, f=3072, k=2),
         torch.bfloat16),
    # a partial last f-block; 16-byte loads
    Case("moe_decode_ffn", "ragged-d96-f200-relu", dict(n=5, e=3, d=96, f=200, k=1),
         torch.bfloat16, activation="relu"),
    Case("moe_decode_ffn", "fp32-silu-top2", dict(n=4, e=8, d=256, f=1024, k=2),
         torch.float32, activation="silu"),
    Case("moe_decode_ffn", "fp16", dict(n=3, e=4, d=512, f=2048, k=1), torch.float16),
    # d and f not multiples of 8: one element a load
    Case("moe_decode_ffn", "fp16-d77-f201-relu", dict(n=3, e=5, d=77, f=201, k=1),
         torch.float16, activation="relu"),
    # DeepSpeed-MoE 350M+MoE-128's expert shape (2.1 GB of stacks), where the
    # experts dominate the weight stream
    Case("moe_decode_ffn", "dsmoe350m-e128-n1", dict(n=1, e=128, d=1024, f=4096, k=1),
         torch.bfloat16),
    Case("moe_decode_ffn", "dsmoe350m-e128-n16", dict(n=16, e=128, d=1024, f=4096, k=1),
         torch.bfloat16),
] + [c for kernel in BS_KERNELS for c in (
    # block-sparse training: GPT-2 125M, micro-batch 24, seq 1024, GPT2_SPARSE
    Case(kernel, "gpt2-train-fixed16", dict(b=24, t=1024, h=12, d=64), torch.bfloat16,
         layout=GPT2_SPARSE, main_path=True),
    # the JAX package's gate shape (ops/kernel_checks.py:check_block_sparse): a
    # bidirectional layout under the causal triangle, so its global columns are
    # walked wholly masked by the rows above them
    Case(kernel, "gate-fixed128-d128", dict(b=2, t=1024, h=4, d=128), torch.bfloat16,
         layout=("FixedSparsityConfig", dict(num_heads=4, block=128, num_local_blocks=2))),
    # random blocks, a different layout per head
    Case(kernel, "bigbird64-fp16-d128", dict(b=2, t=1024, h=4, d=128), torch.float16,
         causal=False, layout=("BigBirdSparsityConfig", dict(
             num_heads=4, block=64, different_layout_per_head=True, num_random_blocks=2,
             num_sliding_window_blocks=3, num_global_blocks=1, seed=1))),
    Case(kernel, "longformer32-fp32", dict(b=2, t=512, h=4, d=64), torch.float32,
         causal=False, layout=("BSLongformerSparsityConfig", dict(
             num_heads=4, block=32, num_sliding_window_blocks=3,
             global_block_indices=[0, 7]))),
    # an empty q-block and one whose only block lies past its diagonal
    Case(kernel, "hand-made-empty-past-diagonal", dict(b=2, t=256, h=2, d=64),
         torch.bfloat16, layout=("hand-made", dict(block=16))),
    # 65 q-blocks: the forward's last 64-row tile holds one q-block
    Case(kernel, "fixed16-t1040", dict(b=2, t=1040, h=12, d=64), torch.bfloat16,
         layout=GPT2_SPARSE),
    # a bidirectional layout under the triangle at block 16: a tile's union
    # holds blocks below the diagonal of rows that do not own them
    Case(kernel, "bigbird16-causal", dict(b=2, t=1024, h=4, d=64), torch.bfloat16,
         layout=("BigBirdSparsityConfig", dict(
             num_heads=4, block=16, different_layout_per_head=True, num_random_blocks=2,
             num_sliding_window_blocks=3, num_global_blocks=1, seed=1))),
    # block 32: a forward tile is 2 q-blocks
    Case(kernel, "fixed32-fp16-d128", dict(b=2, t=1024, h=4, d=128), torch.float16,
         layout=("FixedSparsityConfig", dict(num_heads=4, block=32, num_local_blocks=4,
                                             attention="unidirectional"))),
    # the hand-made layout at block 64, a tile a block: the dk/dv kernel's tile
    # of k-block 2, which no q-block attends to, walks nothing and writes zeros
    Case(kernel, "hand-made-block64", dict(b=2, t=512, h=2, d=64), torch.bfloat16,
         layout=("hand-made", dict(block=64))),
    # head dims other than 64 and 128 on the 128-wide build: [hd]'s
    # block-sparse GPT-2 760M training (d 96, the same layout over 16 heads),
    # f32 at d 80
    Case(kernel, "gpt2-760m-train-fixed16", dict(b=8, t=1024, h=16, d=96), torch.bfloat16,
         layout=GPT2_760M_SPARSE, hd_run="gpt2_760m_sparse"),
    Case(kernel, "longformer32-fp32-d80", dict(b=2, t=512, h=4, d=80), torch.float32,
         causal=False, layout=("BSLongformerSparsityConfig", dict(
             num_heads=4, block=32, num_sliding_window_blocks=3,
             global_block_indices=[0, 7]))),
)]


def case_tags(case: Case) -> set:
    """The tags a selector ``"kernel:tag:..."`` can name: the case's dtype
    (``bfloat16``, ``float16``, ``float32``), ``causal`` or ``full``, its
    name, and ``int8`` or ``int4`` for the dequant-GEMM."""
    tags = {str(case.dtype).split(".")[-1], "causal" if case.causal else "full", case.name}
    if "bits" in case.dims:
        tags.add(f"int{case.dims['bits']}")
    return tags


def selects(selector: str, case: Case) -> bool:
    """``"kernel"`` selects every case of that kernel, ``"kernel:tag:..."``
    those that carry every tag (:func:`case_tags`)."""
    kernel, *tags = selector.split(":")
    return case.kernel == kernel and set(tags) <= case_tags(case)


def hand_made_layout(h: int, t: int, block: int) -> np.ndarray:
    """A causal ``(h, t / block, t / block)`` layout with the rows no shipped
    config makes: every head has its diagonal and the block below it, except
    that q-block 2 has no active block and q-block 3 only k-block 5, which
    lies past its diagonal; heads from 1 on also attend from the last q-block
    to k-block 0, so the heads differ."""
    nb = t // block
    layout = np.zeros((h, nb, nb), np.int64)
    for i in range(nb):
        layout[:, i, max(i - 1, 0):i + 1] = 1
    layout[:, 2] = 0
    layout[:, 3] = 0
    layout[:, 3, 5] = 1
    layout[1:, nb - 1, 0] = 1
    return layout


def case_layout(case: Case) -> np.ndarray:
    """A block-sparse case's ``(h, nb, nb)`` layout at its ``t``."""
    name, kw = case.layout
    if name == "hand-made":
        return hand_made_layout(case.dims["h"], case.dims["t"], kw["block"])
    return getattr(sparse_attention, name)(**kw).make_layout(case.dims["t"])


def case_block(case: Case) -> int:
    return case.layout[1]["block"]


def max_pages(case: Case) -> int:
    return -(-case.dims["cap"] // case.dims["page"])


def make_inputs(case: Case, device, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Seeded inputs on ``device``. Decode caches hold 1e4 in the rows past each
    sequence's length, so a kernel that read them would show it. Paged inputs
    put each slot's live pages at shuffled physical indices, and hold 1e4 in
    the null page 0 (every table pad points at it) and in the rows past each
    slot's length; a tensor of q's shape holding 1e4 is dropped last, so the
    allocator gives its memory to the kernel's output and a row the kernel
    leaves unwritten shows; so is one after the dense decode inputs."""
    gen = torch.Generator(device=device).manual_seed(seed)
    dims = case.dims

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device).to(case.dtype)

    if case.kernel == "moe_decode_ffn":
        return moe_inputs(case, device, seed)
    if case.kernel in BS_KERNELS:
        return block_sparse_inputs(case, device, gen)
    if case.kernel == "quantized_matmul":
        m, k, n, bits = dims["m"], dims["k"], dims["n"], dims["bits"]
        w = torch.randn(k, n, generator=gen, device=device) / float(np.sqrt(k))
        q, s = quantize_grouped(w, dims["group"], bits=bits)
        if bits == 4:
            q = pack_int4(q, s.shape[0])
        return {"x": randn(m, k), "q": q, "scales": s}
    if case.kernel == "flash_fwd" or case.kernel in BWD_KERNELS:
        bh, t, d = dims["b"] * dims["h"], dims["t"], dims["d"]
        inp = {"q": randn(bh, t, d), "k": randn(bh, t, d), "v": randn(bh, t, d)}
        if case.alibi:
            inp["slopes"] = torch.from_numpy(alibi_slopes(dims["h"])).to(device)
        if case.kernel in BWD_KERNELS:
            # o and lse from the plain forward, so the backward's inputs do not
            # depend on the forward kernel
            inp["do"] = randn(bh, t, d)
            o, inp["lse"] = flash_fwd_plain(inp["q"], inp["k"], inp["v"], inp.get("slopes"),
                                            _scale(case), case.causal, dims["h"])
            inp["delta"] = (inp["do"].float() * o.float()).sum(-1)
        return inp
    lens = torch.tensor(case.lens, dtype=torch.int32, device=device)
    if case.kernel == "decode_attention":
        b, h, hk, cap, d = dims["b"], dims["h"], dims["hk"], dims["T"], dims["d"]
        inp = {"q": randn(b, h, d), "k": randn(b, hk, cap, d), "v": randn(b, hk, cap, d),
               "lens": lens}
        for i, n in enumerate(case.lens):
            inp["k"][i, :, n:] = 1e4
            inp["v"][i, :, n:] = 1e4
        poison = torch.full_like(inp["q"], 1e4)
        del poison      # its memory goes to the kernel's output
        return inp
    b, h, hk, ps, d = dims["b"], dims["h"], dims["hk"], dims["page"], dims["d"]
    mp = max_pages(case)
    n_pages = b * mp + 1
    order = np.random.default_rng(seed).permutation(np.arange(1, n_pages))
    table = np.zeros((b, mp), np.int32)
    inp = {"q": randn(b, h, d), "k": randn(n_pages, hk, ps, d), "v": randn(n_pages, hk, ps, d),
           "lens": lens}
    for i, n in enumerate(case.lens):
        live = -(-n // ps)
        table[i, :live] = order[i * mp:i * mp + live]
        if n % ps:
            for name in ("k", "v"):
                inp[name][int(table[i, live - 1]), :, n % ps:] = 1e4
    for name in ("k", "v"):
        inp[name][0] = 1e4
    inp["table"] = torch.from_numpy(table).to(device)
    poison = torch.full_like(inp["q"], 1e4)
    del poison      # its memory goes to the kernel's output
    return inp


def moe_inputs(case: Case, device, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Selected-expert FFN inputs: k distinct experts for each of n / k tokens
    (numpy, seeded), each token's row repeated k times as the model does;
    weights scaled so that h and y are of order 1, biases ~ N(0, 1/4)."""
    n, e, d, f, k = (case.dims[x] for x in ("n", "e", "d", "f", "k"))
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(scale, *shape):
        return (torch.randn(*shape, generator=gen, device=device) * scale).to(case.dtype)

    idx = torch.tensor(moe_inputs_idx(case, seed), dtype=torch.int32, device=device)
    x = randn(1.0, n // k, d).repeat_interleave(k, dim=0)
    return {"x": x, "idx": idx,
            "w1": randn(float(d) ** -0.5, e, d, f), "b1": randn(0.5, e, f),
            "w2": randn(float(f) ** -0.5, e, f, d), "b2": randn(0.5, e, d)}


def block_sparse_inputs(case: Case, device, gen) -> Dict[str, torch.Tensor]:
    """q, k, v ~ N(0, 1) ``(b*h, t, d)`` and the layout's four tables on
    ``device``; on a CUDA device also the kernel's tile tables (``tiles``:
    the forward's for the forward and dq kernels, the transposed layout's for
    dk/dv; their float32 paths ignore them), built here, outside any timing;
    for the backward kernels also do ~ N(0, 1), and o and lse from the plain
    forward (so their inputs do not depend on the forward kernel) with delta
    = rowsum(do * o). o is dropped holding 1e4: the allocator may give its
    memory to the kernel's output, where o's zero rows (a q-block with no
    active block) would hide rows that the kernel leaves unwritten."""
    bh, t, d = case.dims["b"] * case.dims["h"], case.dims["t"], case.dims["d"]

    def randn():
        return torch.randn(bh, t, d, generator=gen, device=device).to(case.dtype)

    layout = case_layout(case)
    inp = {"q": randn(), "k": randn(), "v": randn(),
           **device_tables(build_tables(layout), device)}
    inp["tiles"] = kernel_tile_tables(layout, case_block(case), device,
                                      backward=case.kernel == "block_sparse_bwd_dkv")
    if case.kernel != "block_sparse_fwd":
        inp["do"] = randn()
        o, inp["lse"] = block_sparse_fwd_plain(inp["q"], inp["k"], inp["v"], inp["fwd_idx"],
                                               inp["fwd_cnt"], case_block(case), _scale(case),
                                               case.causal, case.dims["h"])
        inp["delta"] = (inp["do"].float() * o.float()).sum(-1)
        o.fill_(1e4)
    return inp


def _bs_args(case: Case, inp):
    """The block-sparse wrapper's arguments (the plain versions' are the same,
    with the scale given)."""
    if case.kernel == "block_sparse_fwd":
        head = (inp["q"], inp["k"], inp["v"], inp["fwd_idx"], inp["fwd_cnt"])
    else:
        table = "fwd" if case.kernel == "block_sparse_bwd_dq" else "bwd"
        head = (inp["q"], inp["k"], inp["v"], inp["do"], inp["lse"], inp["delta"],
                inp[f"{table}_idx"], inp[f"{table}_cnt"])
    return head + (case_block(case), _scale(case), case.causal, case.dims["h"])


BS_FUNCTIONS = {"block_sparse_fwd": (block_sparse_fwd, block_sparse_fwd_plain),
                "block_sparse_bwd_dq": (block_sparse_bwd_dq, block_sparse_bwd_dq_plain),
                "block_sparse_bwd_dkv": (block_sparse_bwd_dkv, block_sparse_bwd_dkv_plain)}


def _moe_args(case: Case, inp):
    return (inp["x"], inp["idx"], inp["w1"], inp["b1"], inp["w2"], inp["b2"], case.activation)


def effective_group(case: Case) -> int:
    """The dequant-GEMM case's group after the quantizer's degradation."""
    return _group_size(case.dims["k"], case.dims["group"])


def _scale(case: Case) -> float:
    return 1.0 / float(np.sqrt(case.dims["d"]))


def _bwd_args(case: Case, inp):
    return (inp["q"], inp["k"], inp["v"], inp["do"], inp["lse"], inp["delta"],
            inp.get("slopes"), _scale(case), case.causal, case.dims["h"])


def run_kernel(case: Case, inp) -> Tuple[torch.Tensor, ...]:
    """The kernel through its public wrapper: flash ``(o, lse)``, decode and
    paged ``(o,)``, dq ``(dq,)``, dk/dv ``(dk, dv)``, dequant-GEMM and
    selected-expert FFN ``(y,)``."""
    if case.kernel == "moe_decode_ffn":
        return (moe_decode_ffn(*_moe_args(case, inp)),)
    if case.kernel in BS_KERNELS:
        out = BS_FUNCTIONS[case.kernel][0](*_bs_args(case, inp), tiles=inp["tiles"])
        return out if isinstance(out, tuple) else (out,)
    if case.kernel == "quantized_matmul":
        return (quantized_matmul(inp["x"], inp["q"], inp["scales"], bits=case.dims["bits"]),)
    if case.kernel == "flash_bwd_dq":
        return (flash_bwd_dq(*_bwd_args(case, inp)),)
    if case.kernel == "flash_bwd_dkv":
        return flash_bwd_dkv(*_bwd_args(case, inp))
    if case.kernel == "flash_fwd":
        return flash_fwd(inp["q"], inp["k"], inp["v"], inp.get("slopes"), None, case.causal,
                         n_heads=case.dims["h"])
    if case.kernel == "paged_decode_attention":
        return (paged_attention(inp["q"], inp["k"], inp["v"], inp["table"], inp["lens"],
                                case.dims["cap"]),)
    return (decode_attention(inp["q"], inp["k"], inp["v"], inp["lens"]),)


def run_plain(case: Case, inp) -> Tuple[torch.Tensor, ...]:
    """The plain version on the same inputs, same outputs as :func:`run_kernel`."""
    if case.kernel == "moe_decode_ffn":
        return (moe_decode_ffn_plain(*_moe_args(case, inp)),)
    if case.kernel in BS_KERNELS:
        out = BS_FUNCTIONS[case.kernel][1](*_bs_args(case, inp))
        return out if isinstance(out, tuple) else (out,)
    if case.kernel == "quantized_matmul":
        return (quantized_matmul_plain(inp["x"], inp["q"], inp["scales"],
                                       bits=case.dims["bits"]),)
    scale = _scale(case)
    if case.kernel == "flash_bwd_dq":
        return (flash_bwd_dq_plain(*_bwd_args(case, inp)),)
    if case.kernel == "flash_bwd_dkv":
        return flash_bwd_dkv_plain(*_bwd_args(case, inp))
    if case.kernel == "flash_fwd":
        return flash_fwd_plain(inp["q"], inp["k"], inp["v"], inp.get("slopes"), scale,
                               case.causal, case.dims["h"])
    if case.kernel == "paged_decode_attention":
        o = paged_attention_plain(inp["q"], inp["k"], inp["v"], inp["table"], inp["lens"],
                                  case.dims["cap"], scale)
    else:
        o = decode_attention_plain(inp["q"], inp["k"], inp["v"], inp["lens"], scale)
    return (o.masked_fill((inp["lens"] <= 0)[:, None, None], 0),)


def case_splits(case: Case) -> int:
    """The cluster size S the decode or paged wrapper picks for a case."""
    dims = case.dims
    es = torch.tensor([], dtype=case.dtype).element_size()
    g = dims["h"] // dims["hk"]
    if case.kernel == "paged_decode_attention":
        return paged_split(dims["b"], dims["hk"], max_pages(case), dims["page"], dims["d"], g,
                           es)
    return decode_split(dims["b"], dims["hk"], g, dims["T"], dims["d"], es)


def dense_decode_fn(case: Case, inp) -> Callable[[], torch.Tensor]:
    """For a paged case: the dense decode kernel K2 on the same rows laid out
    densely, ``(b, h_kv, max_pages * page, d)``, for comparison only."""
    cap = max_pages(case) * case.dims["page"]
    k, v = (x.contiguous() for x in gather_kv_dense(inp["k"], inp["v"], inp["table"], cap))
    return lambda: decode_attention(inp["q"], k, v, inp["lens"])


def moe_gather_fn(case: Case, inp) -> Callable[[], torch.Tensor]:
    """For a selected-expert FFN case: the gather path ``moe_decode_ffn_xla``
    (``w[idx]`` copies, then cuBLAS batched products), for comparison only."""
    return lambda: moe_decode_ffn_xla(*_moe_args(case, inp))


def library_fn(case: Case, inp) -> Optional[Callable[[], torch.Tensor]]:
    """One PyTorch call computing the same function, as a yardstick of speed
    only (never called by the package), or None where there is none: no single
    call gathers K/V by page index, and a torch without ``enable_gqa`` has no
    GQA decode, and no single call runs a selected expert's FFN (see
    :func:`moe_gather_fn`). The backward kernels' yardstick is SDPA's whole
    backward (dq, dk and dv in one call), run on a graph built once outside
    the timing. The dequant-GEMM's is the GEMM it replaces: ``torch.matmul``
    (cuBLAS) of x by the weight dequantized to x's dtype beforehand. The
    block-sparse kernels' is SDPA with the layout's dense boolean mask (and
    the triangle), forward or its whole backward: it does the dense t^2 work,
    and a row with no valid key gives it NaN, which a timing does not see."""
    dims = case.dims
    if case.kernel == "moe_decode_ffn":
        return None
    if case.kernel in BS_KERNELS:
        b, t, h, d = dims["b"], dims["t"], dims["h"], dims["d"]
        q, k, v = (inp[n].view(b, h, t, d) for n in ("q", "k", "v"))
        mask = torch.from_numpy(sparse_attention.layout_to_dense_mask(
            case_layout(case), case_block(case))).to(q.device)
        if case.causal:
            mask = mask.tril()
        kw = {"attn_mask": mask[None]}
        if case.kernel == "block_sparse_fwd":
            return lambda: F.scaled_dot_product_attention(q, k, v, **kw)
        q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
        out = F.scaled_dot_product_attention(q, k, v, **kw)
        do = inp["do"].view(b, h, t, d)
        return lambda: torch.autograd.grad(out, (q, k, v), do, retain_graph=True)
    if case.kernel == "quantized_matmul":
        w = dequantize_to(inp["q"], inp["scales"], dims["bits"], case.dtype)
        return lambda: torch.matmul(inp["x"], w)
    if case.kernel == "paged_decode_attention":
        return None
    if case.kernel == "flash_fwd" or case.kernel in BWD_KERNELS:
        b, t, h, d = dims["b"], dims["t"], dims["h"], dims["d"]
        q, k, v = (inp[n].view(b, h, t, d) for n in ("q", "k", "v"))
        kw = {"is_causal": case.causal}
        if case.alibi:
            rows = torch.arange(t, device=q.device)[:, None]
            cols = torch.arange(t, device=q.device)[None, :]
            bias = inp["slopes"][:, None, None] * (cols - rows).float()
            if case.causal:
                bias = bias.masked_fill(cols > rows, float("-inf"))
            kw = {"attn_mask": bias.to(q.dtype)}
        if case.kernel == "flash_fwd":
            return lambda: F.scaled_dot_product_attention(q, k, v, **kw)
        q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
        out = F.scaled_dot_product_attention(q, k, v, **kw)
        do = inp["do"].view(b, h, t, d)
        return lambda: torch.autograd.grad(out, (q, k, v), do, retain_graph=True)
    b, h, hk, cap, d = dims["b"], dims["h"], dims["hk"], dims["T"], dims["d"]
    q = inp["q"].view(b, h, 1, d)
    mask = (torch.arange(cap, device=q.device)[None, :] < inp["lens"][:, None])[:, None, None]
    kw = {"enable_gqa": True} if h != hk else {}
    try:
        F.scaled_dot_product_attention(q, inp["k"], inp["v"], attn_mask=mask, **kw)
    except TypeError:            # a torch without enable_gqa
        return None
    return lambda: F.scaled_dot_product_attention(q, inp["k"], inp["v"], attn_mask=mask, **kw)


def work(case: Case) -> Tuple[float, float]:
    """(operations, bytes) the function needs on these inputs: each input read
    once, each output written once; decode counts only the valid cache rows
    (paged: and the live table entries), causal attention only the pairs with
    col <= row; the dequant-GEMM counts the payload, the scales, x and the
    output (in x's dtype), 2 m k n operations; the selected-expert FFN counts
    each distinct selected expert's w1, b1, w2 and b2 once, x, idx and the f32
    output, 4 n d f operations; block-sparse attention counts only the pairs
    in active blocks (causal: with col <= row), and its int32 table."""
    dims = case.dims
    es = torch.tensor([], dtype=case.dtype).element_size()
    if case.kernel in BS_KERNELS:
        return block_sparse_work(case, es)
    if case.kernel == "moe_decode_ffn":
        n, d, f = dims["n"], dims["d"], dims["f"]
        distinct = len(set(moe_inputs_idx(case)))
        expert = (2 * d * f + f + d) * es
        return 4.0 * n * d * f, float(distinct * expert + n * d * es + 4 * n + 4 * n * d)
    if case.kernel == "quantized_matmul":
        m, k, n, bits = dims["m"], dims["k"], dims["n"], dims["bits"]
        groups = k // effective_group(case)
        payload = k * n if bits == 8 else k // 2 * n
        return 2.0 * m * k * n, float(payload + 4 * groups * n + es * m * (k + n))
    d = dims["d"]
    if case.kernel == "flash_fwd" or case.kernel in BWD_KERNELS:
        bh, t = dims["b"] * dims["h"], dims["t"]
        pairs = t * (t + 1) // 2 if case.causal else t * t
        if case.kernel == "flash_bwd_dq":
            # recompute s, dp, dq: 6 d a pair; q, k, v, do in, dq out; f32 lse, delta
            return 6.0 * d * pairs * bh, 5.0 * bh * t * d * es + 8.0 * bh * t
        if case.kernel == "flash_bwd_dkv":
            # recompute s, dp, dv, dk: 8 d a pair; q, k, v, do in, dk, dv out
            return 8.0 * d * pairs * bh, 6.0 * bh * t * d * es + 8.0 * bh * t
        ops = 4.0 * d * pairs * bh
        nbytes = 4.0 * bh * t * d * es + 4.0 * bh * t          # q, k, v, o; f32 lse
        return ops, nbytes
    b, h, hk = dims["b"], dims["h"], dims["hk"]
    cap = dims["T"] if case.kernel == "decode_attention" else dims["cap"]
    rows = float(sum(min(n, cap) for n in case.lens))
    ops = 4.0 * d * h * rows
    nbytes = 2.0 * b * h * d * es + 2.0 * hk * d * es * rows + 4.0 * b
    if case.kernel == "paged_decode_attention":
        nbytes += 4.0 * sum(-(-min(n, cap) // dims["page"]) for n in case.lens)
    return ops, nbytes


def block_sparse_work(case: Case, es: int) -> Tuple[float, float]:
    """(operations, bytes) of a block-sparse case: 4 d (forward: s, o), 6 d
    (dq: s, dp, dq) or 8 d (dk/dv: s, dp, dv, dk) operations for every pair
    the layout makes active, causal pairs only under ``causal``; each of q,
    k, v (and do) read once and each output written once, the f32 lse (and
    delta), and the forward's table (dk/dv: the transposed one)."""
    b, t, h, d = (case.dims[x] for x in ("b", "t", "h", "d"))
    block = case_block(case)
    layout = case_layout(case) != 0
    qi, ki = np.meshgrid(np.arange(layout.shape[1]), np.arange(layout.shape[2]),
                         indexing="ij")
    if case.causal:     # below the diagonal every pair, on it the triangle, above none
        per_block = np.where(ki < qi, block * block,
                             np.where(ki == qi, block * (block + 1) // 2, 0))
    else:
        per_block = np.full(qi.shape, block * block)
    pairs = float(b * (layout * per_block).sum())
    bh = b * h
    tables = build_tables(layout)
    table = "bwd" if case.kernel == "block_sparse_bwd_dkv" else "fwd"
    table_bytes = 4.0 * (tables[f"{table}_idx"].size + tables[f"{table}_cnt"].size)
    if case.kernel == "block_sparse_fwd":
        return 4.0 * d * pairs, 4.0 * bh * t * d * es + 4.0 * bh * t + table_bytes
    if case.kernel == "block_sparse_bwd_dq":
        return 6.0 * d * pairs, 5.0 * bh * t * d * es + 8.0 * bh * t + table_bytes
    return 8.0 * d * pairs, 6.0 * bh * t * d * es + 8.0 * bh * t + table_bytes


def moe_inputs_idx(case: Case, seed: int = 0) -> List[int]:
    """The expert ids :func:`moe_inputs` draws for ``case`` (the same numpy
    draws), without building the tensors."""
    rng = np.random.default_rng(seed)
    e, k = case.dims["e"], case.dims["k"]
    return [int(i) for _ in range(case.dims["n"] // k) for i in rng.permutation(e)[:k]]


def bound_ms(case: Case) -> Tuple[float, str]:
    """The least time the card could take: the larger of bytes over the memory
    rate and operations over the peak rate for the input dtype."""
    ops, nbytes = work(case)
    t_ops = ops / PEAK_OPS_PER_S[case.dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def err_ratio(out: torch.Tensor, ref: torch.Tensor, atol: float, rtol: float) -> float:
    """The largest ``|out - ref| / (atol + rtol * |ref|)`` over the elements: at
    most 1 where every element is within its limit."""
    ref = ref.float()
    return float(((out.float() - ref).abs() / (atol + rtol * ref.abs())).max())


def check(case: Case, device, seed: int = 0) -> Dict[str, float]:
    """Run one case; returns its errors and tolerance (``err_ratio`` <= 1 passes).
    Raises ``AssertionError`` if the kernel disagrees with its plain version or
    returns a non-finite value."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    inp = make_inputs(case, device, seed)
    out, ref = run_kernel(case, inp), run_plain(case, inp)
    atol, rtol = case.tolerance()
    # the forward's second output is the f32 lse, held to LSE_TOLERANCE below
    pairs = list(zip(out, ref))[:1] if case.kernel in FWD_KERNELS else list(zip(out, ref))
    result = {"max_abs_err": max(max_abs_err(a, b) for a, b in pairs), "atol": atol,
              "rtol": rtol, "err_ratio": max(err_ratio(a, b, atol, rtol) for a, b in pairs)}
    if case.kernel in FWD_KERNELS:
        result["lse_err"] = max_abs_err(out[1], ref[1])
    name = f"{case.kernel}/{case.name}"
    if not all(bool(torch.isfinite(o.float()).all()) for o in out):
        raise AssertionError(f"{name}: non-finite output")
    if not result["err_ratio"] <= 1.0:
        raise AssertionError(f"{name}: |kernel - plain| exceeds {atol:g} + {rtol:g} |plain| "
                             f"by a factor {result['err_ratio']:.3g} (max abs err "
                             f"{result['max_abs_err']:.3e})")
    if not result.get("lse_err", 0.0) <= LSE_TOLERANCE:
        raise AssertionError(f"{name}: lse err {result['lse_err']:.3e} > {LSE_TOLERANCE}")
    return result


def run_kernel_checks(device) -> Dict[str, Dict[str, float]]:
    """Every case on ``device`` (a CUDA device); raises on the first failure."""
    return {f"{c.kernel}/{c.name}": check(c, device) for c in CASES}
