from .beam_search_decoder import (  # noqa: F401
    InitState, StateCell, TrainingDecoder, BeamSearchDecoder)
