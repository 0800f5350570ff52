from .whisper_tokenizer import WhisperTokenizer, TIME_PRECISION  # noqa: F401
from .bpe import ByteLevelBPE  # noqa: F401
from .languages import LANGUAGES, TO_LANGUAGE_CODE  # noqa: F401
from .normalizers import (  # noqa: F401
    BasicTextNormalizer, EnglishTextNormalizer, EnglishNumberNormalizer,
)
