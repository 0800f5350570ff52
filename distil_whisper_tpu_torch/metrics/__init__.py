from .wer import wer, process_words, align_words, WordErrors, count_repeated_ngrams  # noqa: F401
