from .tiling import TiledDense, chunked_vocab_cross_entropy, tiled_kernel_from_dense  # noqa: F401
