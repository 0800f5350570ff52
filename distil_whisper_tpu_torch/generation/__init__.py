from .generate import (  # noqa: F401
    GenerationOptions, GenerateOutput, generate, encode_and_generate,
)
