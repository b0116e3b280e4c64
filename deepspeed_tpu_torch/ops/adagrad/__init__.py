from .cpu_adagrad import AdagradState, adagrad  # noqa: F401
