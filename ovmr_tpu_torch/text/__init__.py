from .tokenizer import ClipTokenizer, get_tokenizer
from .tokenize_fn import CONTEXT_LENGTH, eot_indices, tokenize

__all__ = [
    "ClipTokenizer",
    "get_tokenizer",
    "tokenize",
    "eot_indices",
    "CONTEXT_LENGTH",
]
