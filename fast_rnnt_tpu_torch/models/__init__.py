from .decoding import greedy_over_frames, greedy_search, modified_beam_search
from .metrics import edit_distance, token_error_rate
from .serving import StreamServer
from .streaming import (
    StreamingConfig,
    encoder_stream_state,
    streaming_init,
    streaming_reset,
    streaming_step,
)
from .training import (
    LossConfig,
    init_model,
    make_boundary,
    make_train_step,
    pruned_transducer_loss,
)
from .transducer import (
    Encoder,
    Joiner,
    Predictor,
    PrunedTransducer,
    TransducerConfig,
)

__all__ = [
    "Encoder",
    "Joiner",
    "LossConfig",
    "Predictor",
    "PrunedTransducer",
    "StreamServer",
    "StreamingConfig",
    "TransducerConfig",
    "edit_distance",
    "encoder_stream_state",
    "greedy_over_frames",
    "greedy_search",
    "init_model",
    "make_boundary",
    "make_train_step",
    "modified_beam_search",
    "pruned_transducer_loss",
    "streaming_init",
    "streaming_reset",
    "streaming_step",
    "token_error_rate",
]
