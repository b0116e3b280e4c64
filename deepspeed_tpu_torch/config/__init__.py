from .config import DeepSpeedConfig, DeepSpeedConfigError  # noqa: F401
