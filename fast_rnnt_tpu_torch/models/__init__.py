from .decoding import greedy_over_frames, greedy_search, modified_beam_search
from .metrics import edit_distance, token_error_rate
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
    "TransducerConfig",
    "edit_distance",
    "greedy_over_frames",
    "greedy_search",
    "init_model",
    "make_boundary",
    "make_train_step",
    "modified_beam_search",
    "pruned_transducer_loss",
    "token_error_rate",
]
