from .config import DeepSpeedInferenceConfig  # noqa: F401
from .engine import InferenceEngine  # noqa: F401
from .serving import (ChunkedDecodeExecutor, ContinuousBatchingScheduler,  # noqa: F401
                      QueueFullError, RequestHandle, RequestState, ServingConfig,
                      ServingTelemetry, SlotKVPool)
from .speculative import (DraftModelProposer, NgramProposer, SpeculativeConfig,  # noqa: F401
                          make_proposer)
