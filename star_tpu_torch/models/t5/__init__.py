from .encoder import T5Encoder, relative_position_buckets
from .tokenizer import T5HashTokenizer, default_t5_tokenizer
