from .text import CLIPTextEncoder
from .tokenizer import HashTokenizer, default_tokenizer
