"""Block-sparse attention pattern library (numpy only).

The port's own copy of ``deepspeed_tpu/ops/sparse_attention/sparsity_config.py``
(the port imports nothing of the JAX package): ``SparsityConfig``, the Dense,
Fixed, Variable, BigBird, BSLongformer and LocalSlidingWindow configs, and
``layout_to_dense_mask``. Each config produces a layout of shape
``(num_heads, num_blocks, num_blocks)`` with 1 where a ``block x block`` tile
of the attention matrix is computed. Layouts are built on the host, once per
sequence length; ``ops/attention/block_sparse.py`` turns them into the
kernels' block tables, and ``layout_to_dense_mask`` expands them for the
masked dense path and the tests.

Variable and BigBird draw their random blocks from one
``np.random.default_rng(seed)`` per config, in the JAX package's order, so the
layouts equal the JAX package's bit for bit on every ``make_layout`` call
(``tests/test_torch_block_sparse.py``).
"""

import math
from typing import List, Optional

import numpy as np


class SparsityConfig:
    """Base: block size, head count, per-head layout policy (reference :9)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head
        self.num_layout_heads = num_heads if different_layout_per_head else 1

    def setup_layout(self, seq_len: int) -> np.ndarray:
        if seq_len % self.block != 0:
            raise ValueError(f"Sequence length {seq_len} must be divisible by "
                             f"block size {self.block}")
        num_blocks = seq_len // self.block
        return np.zeros((self.num_heads, num_blocks, num_blocks), dtype=np.int64)

    def check_and_propagate_first_head_layout(self, layout: np.ndarray) -> np.ndarray:
        if not self.different_layout_per_head:
            layout[1:] = layout[0]
        return layout

    def make_layout(self, seq_len: int) -> np.ndarray:
        raise NotImplementedError


class DenseSparsityConfig(SparsityConfig):
    """All blocks on — for comparison/debug (reference :63)."""

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        layout[:] = 1
        return layout


def _local_windows(layout: np.ndarray, h: int, window_starts: List[int],
                   window_ends: List[int], unidirectional: bool):
    """Dense (or causal) blocks within each [start, end) window."""
    n = layout.shape[1]
    row = np.arange(n)[:, None]
    col = np.arange(n)[None, :]
    for start, end in zip(window_starts, window_ends):
        end = min(end, n)
        inside = (row >= start) & (row < end) & (col >= start) & (col < end)
        if unidirectional:
            inside &= col <= row
        layout[h][inside] = 1


class FixedSparsityConfig(SparsityConfig):
    """Fixed local windows + periodic global blocks (reference :94)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_local_blocks: int = 4, num_global_blocks: int = 1,
                 attention: str = "bidirectional",
                 horizontal_global_attention: bool = False,
                 num_different_global_patterns: int = 1):
        super().__init__(num_heads, block, different_layout_per_head)
        if num_local_blocks % num_global_blocks != 0:
            raise ValueError(
                f"num_local_blocks {num_local_blocks} must be divisible by "
                f"num_global_blocks {num_global_blocks}")
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError(
                "only uni/bi-directional attention is supported")
        if attention != "bidirectional" and horizontal_global_attention:
            raise ValueError("horizontal global attention requires bidirectional")
        if num_different_global_patterns > 1 and not different_layout_per_head:
            raise ValueError("multiple global patterns require "
                             "different_layout_per_head=True")
        if num_different_global_patterns > num_local_blocks // num_global_blocks:
            raise ValueError(
                f"num_different_global_patterns {num_different_global_patterns} "
                f"cannot exceed {num_local_blocks // num_global_blocks}")
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.num_different_global_patterns = num_different_global_patterns

    def set_local_layout(self, h: int, layout: np.ndarray) -> np.ndarray:
        n = layout.shape[1]
        starts = list(range(0, n, self.num_local_blocks))
        _local_windows(layout, h, starts,
                       [s + self.num_local_blocks for s in starts],
                       self.attention == "unidirectional")
        return layout

    def set_global_layout(self, h: int, layout: np.ndarray) -> np.ndarray:
        n = layout.shape[1]
        g = self.num_global_blocks
        first = self.num_local_blocks - \
            (1 + h % self.num_different_global_patterns) * g
        end = n - (n % self.num_local_blocks)
        starts = list(range(first, end, self.num_local_blocks))
        if end < n:  # short last window (reference :214)
            starts.append(min(end + first, n - g))
        for i in starts:
            first_row = 0 if self.attention == "bidirectional" else i
            layout[h, first_row:, i:i + g] = 1
            if self.horizontal_global_attention:
                layout[h, i:i + g, :] = 1
        return layout

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            self.set_local_layout(h, layout)
            self.set_global_layout(h, layout)
        return self.check_and_propagate_first_head_layout(layout)


class VariableSparsityConfig(SparsityConfig):
    """Random + variable-width local windows + listed global blocks (reference :243)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_random_blocks: int = 0,
                 local_window_blocks: Optional[List[int]] = None,
                 global_block_indices: Optional[List[int]] = None,
                 global_block_end_indices: Optional[List[int]] = None,
                 attention: str = "bidirectional",
                 horizontal_global_attention: bool = False,
                 seed: int = 0):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        if local_window_blocks is not None and not local_window_blocks:
            raise ValueError("local_window_blocks must be non-empty "
                             "(every row needs a local window size)")
        self.local_window_blocks = (local_window_blocks
                                    if local_window_blocks is not None else [4])
        self.global_block_indices = (global_block_indices
                                     if global_block_indices is not None else [0])
        if global_block_end_indices is not None:
            if len(self.global_block_indices) != len(global_block_end_indices):
                raise ValueError("global start/end index lists must match in length")
            for s, e in zip(self.global_block_indices, global_block_end_indices):
                if s >= e:
                    raise ValueError(f"global start {s} must be < end {e}")
        self.global_block_end_indices = global_block_end_indices
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError(
                "only uni/bi-directional attention is supported")
        if attention != "bidirectional" and horizontal_global_attention:
            raise ValueError("horizontal global attention requires bidirectional")
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self._rng = np.random.default_rng(seed)

    def set_random_layout(self, h: int, layout: np.ndarray) -> np.ndarray:
        n = layout.shape[1]
        if n < self.num_random_blocks:
            raise ValueError(
                f"num_random_blocks {self.num_random_blocks} exceeds rows {n}")
        for row in range(n):
            cols = self._rng.choice(n, size=self.num_random_blocks, replace=False)
            layout[h, row, cols] = 1
        return layout

    def set_local_layout(self, h: int, layout: np.ndarray) -> np.ndarray:
        n = layout.shape[1]
        starts, ends = [], []
        pos = 0
        for size in self.local_window_blocks:
            starts.append(pos)
            ends.append(min(pos + size, n))
            pos += size
        while pos < n:  # repeat the last window size (reference :357)
            starts.append(pos)
            ends.append(min(pos + size, n))
            pos += size
        _local_windows(layout, h, starts, ends,
                       self.attention == "unidirectional")
        return layout

    def set_global_layout(self, h: int, layout: np.ndarray) -> np.ndarray:
        n = layout.shape[1]
        if self.global_block_end_indices is None:
            spans = [(i, i + 1) for i in self.global_block_indices]
        else:
            spans = list(zip(self.global_block_indices,
                             self.global_block_end_indices))
        for start, end in spans:
            if start >= n:
                continue
            end = min(end, n)
            if self.horizontal_global_attention:
                layout[h, start:end, :] = 1
            first_row = 0 if self.attention == "bidirectional" else start
            layout[h, first_row:, start:end] = 1
        return layout

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            self.set_random_layout(h, layout)
            self.set_local_layout(h, layout)
            self.set_global_layout(h, layout)
        return self.check_and_propagate_first_head_layout(layout)


class BigBirdSparsityConfig(SparsityConfig):
    """Random + sliding window + ITC global blocks (reference :421; the BigBird paper
    pattern, arXiv:2007.14062)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_random_blocks: int = 1,
                 num_sliding_window_blocks: int = 3,
                 num_global_blocks: int = 1,
                 attention: str = "bidirectional",
                 seed: int = 0):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError(
                "only uni/bi-directional attention is supported")
        self.attention = attention
        self._rng = np.random.default_rng(seed)

    def set_random_layout(self, h: int, layout: np.ndarray) -> np.ndarray:
        n = layout.shape[1]
        if n < self.num_random_blocks:
            raise ValueError(
                f"num_random_blocks {self.num_random_blocks} exceeds rows {n}")
        for row in range(n):
            hi = n if self.attention == "bidirectional" else row + 1
            k = min(self.num_random_blocks, hi)
            cols = self._rng.choice(hi, size=k, replace=False)
            layout[h, row, cols] = 1
        return layout

    def set_sliding_window_layout(self, h: int, layout: np.ndarray) -> np.ndarray:
        n = layout.shape[1]
        if n < self.num_sliding_window_blocks:
            raise ValueError(
                f"num_sliding_window_blocks {self.num_sliding_window_blocks} "
                f"exceeds rows {n}")
        w = self.num_sliding_window_blocks // 2
        row = np.arange(n)[:, None]
        col = np.arange(n)[None, :]
        layout[h][np.abs(row - col) <= w] = 1
        return layout

    def set_global_layout_itc(self, h: int, layout: np.ndarray) -> np.ndarray:
        n = layout.shape[1]
        if n < self.num_global_blocks:
            raise ValueError(
                f"num_global_blocks {self.num_global_blocks} exceeds rows {n}")
        g = self.num_global_blocks
        layout[h, :g, :] = 1
        layout[h, :, :g] = 1
        if self.attention == "unidirectional":
            layout[h] = np.tril(layout[h])
        return layout

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            self.set_random_layout(h, layout)
            self.set_sliding_window_layout(h, layout)
            self.set_global_layout_itc(h, layout)
        return self.check_and_propagate_first_head_layout(layout)


class BSLongformerSparsityConfig(SparsityConfig):
    """Block-sparse Longformer: sliding window + listed global rows/cols
    (reference :559; arXiv:2004.05150)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_sliding_window_blocks: int = 3,
                 global_block_indices: Optional[List[int]] = None,
                 global_block_end_indices: Optional[List[int]] = None,
                 attention: str = "bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = (global_block_indices
                                     if global_block_indices is not None else [0])
        if global_block_end_indices is not None:
            if len(self.global_block_indices) != len(global_block_end_indices):
                raise ValueError("global start/end index lists must match in length")
            for s, e in zip(self.global_block_indices, global_block_end_indices):
                if s >= e:
                    raise ValueError(f"global start {s} must be < end {e}")
        self.global_block_end_indices = global_block_end_indices
        self.attention = attention

    def set_sliding_window_layout(self, h: int, layout: np.ndarray) -> np.ndarray:
        n = layout.shape[1]
        if n < self.num_sliding_window_blocks:
            raise ValueError(
                f"num_sliding_window_blocks {self.num_sliding_window_blocks} "
                f"exceeds rows {n}")
        w = self.num_sliding_window_blocks // 2
        row = np.arange(n)[:, None]
        col = np.arange(n)[None, :]
        layout[h][np.abs(row - col) <= w] = 1
        return layout

    def set_global_layout(self, h: int, layout: np.ndarray) -> np.ndarray:
        n = layout.shape[1]
        if self.global_block_end_indices is None:
            spans = [(i, i + 1) for i in self.global_block_indices]
        else:
            spans = list(zip(self.global_block_indices,
                             self.global_block_end_indices))
        for start, end in spans:
            if start >= n:
                continue
            end = min(end, n)
            layout[h, start:end, :] = 1
            layout[h, :, start:end] = 1
        if self.attention == "unidirectional":
            layout[h] = np.tril(layout[h])
        return layout

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            self.set_sliding_window_layout(h, layout)
            self.set_global_layout(h, layout)
        return self.check_and_propagate_first_head_layout(layout)


class LocalSlidingWindowSparsityConfig(SparsityConfig):
    """Pure sliding window (reference :686)."""

    def __init__(self, num_heads: int, block: int = 16,
                 num_sliding_window_blocks: int = 3,
                 attention: str = "unidirectional"):
        super().__init__(num_heads, block)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.attention = attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        if n < self.num_sliding_window_blocks:
            raise ValueError(
                f"num_sliding_window_blocks {self.num_sliding_window_blocks} "
                f"exceeds rows {n}")
        w = self.num_sliding_window_blocks // 2
        row = np.arange(n)[:, None]
        col = np.arange(n)[None, :]
        for h in range(self.num_layout_heads):
            if self.attention == "bidirectional":
                layout[h][np.abs(row - col) <= w] = 1
            else:
                layout[h][(col <= row) & (row - col <= w)] = 1
        return self.check_and_propagate_first_head_layout(layout)


def layout_to_dense_mask(layout: np.ndarray, block: int) -> np.ndarray:
    """Expand a (H, nb, nb) block layout into a (H, T, T) boolean attention mask —
    the XLA fallback path and the ground truth for kernel tests."""
    return np.kron(layout, np.ones((block, block), dtype=layout.dtype)).astype(bool)
