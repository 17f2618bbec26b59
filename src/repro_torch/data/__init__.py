"""Data pipeline: the dataframe system feeding training (paper → practice)."""
from .pipeline import DataPipeline, PipelineConfig  # noqa: F401
from .synthetic import numeric_matrix_frame, synthetic_corpus, taxi_like_frame  # noqa: F401
from .tokenizer import BOS, EOS, PAD, HashTokenizer  # noqa: F401
