from .generate import (  # noqa: F401
    GenerationOptions, GenerateOutput, build_generate, encode_and_generate,
    generate, generate_eager,
)
from .beam import beam_search, encode_and_beam_search, BeamOutput  # noqa: F401
from .sequential import (  # noqa: F401
    SequentialOptions, SequentialTranscriber, compression_ratio,
)
