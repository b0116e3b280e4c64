"""1-bit optimizers (the JAX package's ``runtime/fp16/onebit``)."""
from .adam import OnebitAdamState, ZeroOneAdamState, onebit_adam, zero_one_adam  # noqa: F401
from .lamb import OnebitLambState, onebit_lamb  # noqa: F401
