from .generate import (  # noqa: F401
    GenerationOptions, GenerateOutput, generate, encode_and_generate,
)
from .beam import beam_search, encode_and_beam_search, BeamOutput  # noqa: F401
from .sequential import (  # noqa: F401
    SequentialOptions, SequentialTranscriber, compression_ratio,
)
