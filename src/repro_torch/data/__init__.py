from .synthetic import numeric_matrix_frame, taxi_like_frame  # noqa: F401
from .tokenizer import BOS, EOS, PAD, HashTokenizer  # noqa: F401
