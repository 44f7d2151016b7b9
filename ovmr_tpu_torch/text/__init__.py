from .tokenizer import ClipTokenizer, get_tokenizer
from .tokenize_fn import CONTEXT_LENGTH, eot_indices, tokenize
from .templates import CUSTOM_TEMPLATES, IMAGENET_TEMPLATES, IMAGENET_TEMPLATES_SELECT

__all__ = [
    "ClipTokenizer",
    "get_tokenizer",
    "tokenize",
    "eot_indices",
    "CONTEXT_LENGTH",
    "CUSTOM_TEMPLATES",
    "IMAGENET_TEMPLATES",
    "IMAGENET_TEMPLATES_SELECT",
]
